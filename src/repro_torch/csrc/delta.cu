// K1 — delta encode: out[0] = x[0], out[i] = x[i] - x[i-1] (wrapping, unsigned).
//
// Replaces the TPU kernel src/repro/kernels/delta.py, delta_encode_pallas
// (_encode_kernel), which walked 2048-element blocks in order and read the
// previous block's last element through a second block spec.
//
// Bound: bytes.  The function reads n*w bytes and writes n*w bytes and does
// one subtraction per element.  Design: one thread per element reads its own
// predecessor, so no block carry exists and blocks run in any order; the
// x[i-1] load hits the line its neighbour thread just fetched, so the kernel
// moves each byte once from device memory.  Templated on the element type so
// widths 1, 2, 4 and 8 (an int64 timestamp column) all run here, and the
// unsigned arithmetic wraps exactly as the wire codec's numpy subtraction.
#include "common.cuh"

template <typename T>
__global__ void delta_encode_kernel(const T* __restrict__ x, T* __restrict__ out,
                                    long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T prev = i ? x[i - 1] : T(0);
    out[i] = (T)(x[i] - prev);
  }
}

template <typename T>
static int launch(const void* x, void* out, long long n, cudaStream_t stream) {
  const int threads = 256;
  delta_encode_kernel<T><<<repro_grid(n, threads, 1LL << 20), threads, 0, stream>>>(
      (const T*)x, (T*)out, n);
  return (int)cudaGetLastError();
}

REPRO_API int repro_delta_encode(const void* x, void* out, long long n, int width,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch<uint8_t>(x, out, n, s);
    case 2: return launch<uint16_t>(x, out, n, s);
    case 4: return launch<uint32_t>(x, out, n, s);
    case 8: return launch<unsigned long long>(x, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 — delta decode: x[i] = d[0] + ... + d[i] (wrapping, unsigned), the
// inclusive prefix sum that inverts K1.
//
// Replaces the TPU kernel src/repro/kernels/delta.py, delta_decode_pallas
// (_block_sum_kernel, then an XLA exclusive cumsum of the block sums, then
// _scan_carry_kernel), whose carry relied on the grid running in order.
//
// Bound: bytes.  The function reads n*w bytes and writes n*w bytes with one
// addition per element.  Design: blocks on the card run in no order, so the
// cross-block carry takes three launches, all of them here:
//   1. delta_block_sums  — each block reduces its tile of DTILE elements;
//   2. delta_scan_sums   — one block turns the block sums into an exclusive
//                          prefix, in chunks of blockDim with a running carry;
//   3. delta_scan_carry  — each block stages its tile in shared memory
//                          (coalesced both ways), scans DITEMS elements per
//                          thread in registers, scans the thread totals with
//                          warp shuffles, and adds its block's carry.
// All sums are unsigned (32 bits for widths 1, 2 and 4, 64 bits for width 8)
// and are cut to the element's width only at the store: 2^(8w) divides the
// accumulator's modulus, so the result is the wrapping sum of the element
// type exactly, and no step relies on signed overflow.  The input is read
// twice (passes 1 and 3), so the kernel moves 3 n*w bytes against the
// function's 2 n*w.
#define DTHREADS 256
#define DITEMS 8
#define DTILE (DTHREADS * DITEMS)

template <typename T> struct Acc { typedef unsigned int type; };
template <> struct Acc<unsigned long long> { typedef unsigned long long type; };

template <typename T>
__global__ void delta_block_sums(const T* __restrict__ d,
                                 typename Acc<T>::type* __restrict__ sums,
                                 long long n) {
  typedef typename Acc<T>::type A;
  const long long base = (long long)blockIdx.x * DTILE;
  A s = 0;
  for (int k = threadIdx.x; k < DTILE; k += DTHREADS) {
    const long long i = base + k;
    if (i < n) s += (A)d[i];
  }
  A total;
  block_exclusive_scan<A>(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

template <typename A>
__global__ void delta_scan_sums(A* __restrict__ sums, long long n_blocks) {
  A carry = 0;
  for (long long c0 = 0; c0 < n_blocks; c0 += blockDim.x) {
    const long long i = c0 + threadIdx.x;
    const A v = i < n_blocks ? sums[i] : (A)0;
    A total;
    const A before = block_exclusive_scan<A>(v, &total);
    if (i < n_blocks) sums[i] = carry + before;
    carry += total;
  }
}

template <typename T>
__global__ void delta_scan_carry(const T* __restrict__ d,
                                 const typename Acc<T>::type* __restrict__ carry_in,
                                 T* __restrict__ out, long long n) {
  typedef typename Acc<T>::type A;
  __shared__ T tile[DTILE];
  const long long base = (long long)blockIdx.x * DTILE;
  for (int k = threadIdx.x; k < DTILE; k += DTHREADS) {
    const long long i = base + k;
    tile[k] = i < n ? d[i] : (T)0;
  }
  __syncthreads();
  A run[DITEMS];
  A acc = 0;
#pragma unroll
  for (int j = 0; j < DITEMS; ++j) {
    acc += (A)tile[threadIdx.x * DITEMS + j];
    run[j] = acc;
  }
  A total;
  const A before = block_exclusive_scan<A>(acc, &total) + carry_in[blockIdx.x];
  // block_exclusive_scan synchronised the block: every tile read is done
#pragma unroll
  for (int j = 0; j < DITEMS; ++j) tile[threadIdx.x * DITEMS + j] = (T)(before + run[j]);
  __syncthreads();
  for (int k = threadIdx.x; k < DTILE; k += DTHREADS) {
    const long long i = base + k;
    if (i < n) out[i] = tile[k];
  }
}

template <typename T>
static int launch_decode(const void* d, void* out, void* scratch, long long n,
                         cudaStream_t stream) {
  typedef typename Acc<T>::type A;
  const long long n_blocks = (n + DTILE - 1) / DTILE;
  A* sums = (A*)scratch;
  delta_block_sums<T><<<(unsigned int)n_blocks, DTHREADS, 0, stream>>>((const T*)d, sums, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  delta_scan_sums<A><<<1, 1024, 0, stream>>>(sums, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  delta_scan_carry<T><<<(unsigned int)n_blocks, DTHREADS, 0, stream>>>(
      (const T*)d, sums, (T*)out, n);
  return (int)cudaGetLastError();
}

// The scratch that repro_delta_decode needs for n elements: one 8-byte
// accumulator per tile (enough for every width).  The tile size lives here
// alone; the wrapper asks for the count.
REPRO_API long long repro_delta_decode_scratch(long long n) {
  return (n + DTILE - 1) / DTILE;
}

REPRO_API int repro_delta_decode(const void* d, void* out, void* scratch,
                                 long long n_scratch, long long n, int width,
                                 void* stream) {
  const long long n_blocks = repro_delta_decode_scratch(n);
  if (n_blocks < 1 || n_blocks > 0x7FFFFFFFLL || n_scratch < n_blocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch_decode<uint8_t>(d, out, scratch, n, s);
    case 2: return launch_decode<uint16_t>(d, out, scratch, n, s);
    case 4: return launch_decode<uint32_t>(d, out, scratch, n, s);
    case 8: return launch_decode<unsigned long long>(d, out, scratch, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
