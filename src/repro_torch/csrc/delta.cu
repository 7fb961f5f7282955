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
#include "scan.cuh"

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
// addition per element.  Design: one launch, the single-pass scan with
// decoupled look-back of scan.cuh, so each byte is read once and written
// once.  A block takes one tile of DTILE_BYTES: each thread owns a
// contiguous run of DRUN bytes (16 uint8, 8 uint16, 4 uint32 or 2 uint64
// per 16-byte vector), which its warp loads as streaming vectors (load_run
// in common.cuh, shifted where d is a view off the vector alignment) and
// hands over through shared memory.  The thread sums its run in registers,
// and the block scans the thread totals (block_exclusive_scan).  Warp 0
// then looks back for the sum of all earlier tiles (tiles_before); each
// thread scans its run again from its base, and its warp stores the runs
// as streaming vectors.  The run and block sizes were the fastest on an
// H100 among runs of 32-128 bytes and blocks of 128-512 threads.
//
// All sums are unsigned (32 bits for widths 1, 2 and 4, 64 bits for width 8)
// and are cut to the element's width only at the store: 2^(8w) divides the
// accumulator's modulus, so the result is the wrapping sum of the element
// type exactly, and no step relies on signed overflow.
#ifndef DTILE_BYTES  // the bytes of a tile, from the build (kernels/_build.py)
#error "delta.cu is built with -DDTILE_BYTES=<bytes of a tile>"
#endif
#define DTHREADS 128
#define DRUN (DTILE_BYTES / DTHREADS)  // input bytes a thread owns: 128, eight vectors
static_assert(DRUN % 16 == 0 && DRUN * DTHREADS == DTILE_BYTES, "a run is whole vectors");

template <typename T> struct Acc { typedef uint32_t type; };
template <> struct Acc<unsigned long long> { typedef unsigned long long type; };

// The scratch bytes of a call over `tiles` tiles of `width`-byte elements.
static long long scratch_bytes(long long tiles, int width) {
  return width == 8 ? scan_scratch_bytes<unsigned long long>(tiles)
                    : scan_scratch_bytes<uint32_t>(tiles);
}

// Element j of a run held as its DRUN / 4 words, zero-extended to A.
template <typename T, typename A>
__device__ __forceinline__ A item(const uint32_t* b, int j) {
  constexpr int W = (int)sizeof(T);
  if constexpr (W == 8)
    return b[2 * j] | ((A)b[2 * j + 1] << 32);
  else
    return (b[j / (4 / W)] >> (8 * W * (j % (4 / W)))) & (0xFFFFFFFFu >> (32 - 8 * W));
}

// The run's words with element j replaced by base + x[0] + ... + x[j], cut to T.
template <typename T, typename A>
__device__ __forceinline__ void scan_words(uint32_t* b, A base) {
  constexpr int W = (int)sizeof(T);
  A run = base;
  if constexpr (W == 8) {
#pragma unroll
    for (int j = 0; j < DRUN / 8; ++j) {
      run += item<T, A>(b, j);
      b[2 * j] = (uint32_t)run;
      b[2 * j + 1] = (uint32_t)(run >> 32);
    }
  } else {
    constexpr int PW = 4 / W;
    constexpr uint32_t M = 0xFFFFFFFFu >> (32 - 8 * W);
#pragma unroll
    for (int k = 0; k < DRUN / 4; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < PW; ++i) {
        run += item<T, A>(b, k * PW + i);
        word |= (run & M) << (8 * W * i);
      }
      b[k] = word;
    }
  }
}

// A thread keeps its run as the DRUN / 4 words it loaded, whatever the
// width, and scans them twice: once for its total, once from its base for
// the store.  The elements widened to A would take up to twice the
// registers (uint8 into 32-bit sums) and cut the blocks that fit on an SM,
// and with them the bytes in flight.  A warp passes its 32 runs through
// shared memory on the way in and out (stage_slot), so that each load and
// store instruction covers 512 contiguous bytes: 16-byte accesses at the
// stride of a run leave each 32-byte sector half written per instruction.
template <typename T, bool SHIFTED>
__global__ void __launch_bounds__(DTHREADS)
delta_decode_kernel(const T* __restrict__ d, T* __restrict__ out, long long n,
                    unsigned char* scratch) {
  typedef typename Acc<T>::type A;
  constexpr int W = (int)sizeof(T);
  constexpr int ITEMS = DRUN / W;
  constexpr int V = DRUN / 16;  // vectors per run
  constexpr long long TILE = DTILE_BYTES / W;
  __shared__ uint4 stage[DTHREADS / 32][32 * V];
  const long long tile = take_tile(scratch);
  const int lane = threadIdx.x & 31;
  const long long g = tile * TILE + (long long)threadIdx.x * ITEMS;
  const long long gw = g - (long long)lane * ITEMS;  // the warp's first element
  const bool warp_full = gw + 32 * ITEMS <= n;     // the same in every lane
  uint4* st = stage[threadIdx.x >> 5];
  uint32_t b[DRUN / 4] = {};
  if (warp_full) {
    const uint8_t* wp = reinterpret_cast<const uint8_t*>(d + gw);
#pragma unroll
    for (int k = 0; k < V; ++k) {  // the warp's vector 32k + lane
      uint32_t w[4];
      load_run<1, SHIFTED>(wp + 16 * (32 * k + lane), reinterpret_cast<const uint8_t*>(d + n),
                           true, w);
      st[stage_slot(32 * k + lane)] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncwarp();
#pragma unroll
    for (int v = 0; v < V; ++v) words_of(st[stage_slot(lane * V + v)], b + 4 * v);
  } else {  // the last warp's runs: element by element, zero past n
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (g + j < n) {
        const A x = d[g + j];
        if constexpr (W == 8) {
          b[2 * j] = (uint32_t)x;
          b[2 * j + 1] = (uint32_t)((unsigned long long)x >> 32);
        } else {
          b[j / (4 / W)] |= (uint32_t)x << (8 * W * (j % (4 / W)));
        }
      }
    }
  }
  A total = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) total += item<T, A>(b, j);
  A tile_total;
  const A before = block_exclusive_scan<A>(total, &tile_total);
  scan_words<T, A>(b, tiles_before<A>(scratch, tile, tile_total) + before);
  if (warp_full) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      st[stage_slot(lane * V + v)] = make_uint4(b[4 * v], b[4 * v + 1], b[4 * v + 2], b[4 * v + 3]);
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out + gw);
#pragma unroll
    for (int k = 0; k < V; ++k) __stcs(dst + 32 * k + lane, st[stage_slot(32 * k + lane)]);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (g + j < n) out[g + j] = (T)item<T, A>(b, j);
  }
}

template <typename T>
static int launch_decode(const void* d, void* out, void* scratch, long long tiles,
                         long long n, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)scratch_bytes(tiles, (int)sizeof(T)),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  if ((uintptr_t)d % 16 == 0)
    delta_decode_kernel<T, false><<<(unsigned int)tiles, DTHREADS, 0, stream>>>(
        (const T*)d, (T*)out, n, (unsigned char*)scratch);
  else
    delta_decode_kernel<T, true><<<(unsigned int)tiles, DTHREADS, 0, stream>>>(
        (const T*)d, (T*)out, n, (unsigned char*)scratch);
  return (int)cudaGetLastError();
}

// The scratch bytes that repro_delta_decode needs for n elements of `width`
// bytes; the wrapper asks for the size.
REPRO_API long long repro_delta_decode_scratch(long long n, int width) {
  return scratch_bytes((n * width + DTILE_BYTES - 1) / DTILE_BYTES, width);
}

// d: n elements of `width` bytes, aligned to the element; out: n elements,
// 16-byte aligned (a fresh allocation); scratch: n_scratch bytes.
REPRO_API int repro_delta_decode(const void* d, void* out, void* scratch,
                                 long long n_scratch, long long n, int width,
                                 void* stream) {
  if (width != 1 && width != 2 && width != 4 && width != 8) return (int)cudaErrorInvalidValue;
  const long long tiles = (n * width + DTILE_BYTES - 1) / DTILE_BYTES;
  if (tiles < 1 || tiles > 0x7FFFFFFFLL || n_scratch < scratch_bytes(tiles, width) ||
      (uintptr_t)d % width || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch_decode<uint8_t>(d, out, scratch, tiles, n, s);
    case 2: return launch_decode<uint16_t>(d, out, scratch, tiles, n, s);
    case 4: return launch_decode<uint32_t>(d, out, scratch, tiles, n, s);
    default: return launch_decode<unsigned long long>(d, out, scratch, tiles, n, s);
  }
}
