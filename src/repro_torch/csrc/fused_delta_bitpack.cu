// K11 — fused delta + bitpack: d[i] = (x[i] - x[i-1]) mod 2^32 with
// x[-1] = 0, on the stream's values zero-extended to 32 bits, masked to
// `bits` and packed PER = 32 / bits to a word, LSB-first, in one pass.
//
// Replaces the TPU kernel src/repro/kernels/fused_delta_bitpack.py,
// fused_delta_bitpack_pallas (_fused_encode_kernel), which read the previous
// block's last value through a second block spec.
//
// Bound: bytes.  Reads n*w bytes and writes n*bits/8 bytes; the delta stream
// never reaches device memory.  Design: one thread per output word reads the
// predecessor of its first value, as K1 does (delta.cu), so no carry crosses
// blocks and they run in any order.  Slots of the last word past n are 0.
//
// K12 — fused decode: unpack, then the u32 inclusive prefix sum, cut to the
// output width on the store (equal to the reference's
// np.cumsum(d, dtype=np.uint32).astype(UNSIGNED[width])).
//
// Replaces fused_delta_bitpack.py, fused_delta_bitpack_decode_pallas
// (_fused_decode_sum_kernel, an XLA cumsum of the block sums, then
// _fused_decode_scan_kernel), whose carry relied on the grid running in order.
//
// Bound: bytes.  Reads n*bits/8 bytes and writes n*w bytes.  Design: K2's
// three launches (delta.cu), on packed words:
//   1. fdb_block_sums — each block sums the deltas of its tile of words;
//   2. fdb_scan_sums  — one block turns the sums into an exclusive prefix;
//   3. fdb_scan_carry — each block stages its words in shared memory, each
//                       thread unpacks VPT deltas into registers and scans
//                       them, the block scans the thread totals, and the
//                       values are staged in shared memory for coalesced
//                       stores.
// Both passes unpack in registers, so the full-width delta stream never
// reaches device memory (the point of the TPU kernel); the words are read
// twice, so the kernel moves 2 n*bits/8 + n*w bytes.
#include "bitpack.cuh"

// ------------------------------------------------------------------ K11
template <typename T, int BITS>
__global__ void fused_delta_bitpack_kernel(const T* __restrict__ x,
                                           uint32_t* __restrict__ out, long long n,
                                           long long m) {
  constexpr int PER = Packing<BITS>::PER;
  constexpr uint32_t MASK = Packing<BITS>::MASK;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < m;
       w += stride) {
    const long long i0 = w * PER;
    uint32_t prev = i0 ? (uint32_t)x[i0 - 1] : 0u;
    uint32_t acc = 0;
    if (i0 + PER <= n) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const uint32_t cur = x[i0 + k];
        acc |= ((cur - prev) & MASK) << (k * BITS);
        prev = cur;
      }
    } else {
      for (int k = 0; i0 + k < n; ++k) {
        const uint32_t cur = x[i0 + k];
        acc |= ((cur - prev) & MASK) << (k * BITS);
        prev = cur;
      }
    }
    out[w] = acc;
  }
}

template <typename T, int BITS>
static int launch_encode(const void* x, void* out, long long n, cudaStream_t stream) {
  const long long m = (n + Packing<BITS>::PER - 1) / Packing<BITS>::PER;
  const int threads = 256;
  fused_delta_bitpack_kernel<T, BITS>
      <<<repro_grid(m, threads, 1LL << 20), threads, 0, stream>>>((const T*)x,
                                                                  (uint32_t*)out, n, m);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K12
#define FTHREADS 256

// Tile of one decode block: VPT values (at least 8, and whole words) in WPT
// words per thread.
template <int BITS>
struct Tile {
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int VPT = PER > 8 ? PER : 8;
  static constexpr int WPT = VPT / PER;
  static constexpr int WORDS = FTHREADS * WPT;
  static constexpr int VALUES = FTHREADS * VPT;
};

template <int BITS>
__device__ __forceinline__ uint32_t field_sum(uint32_t word) {
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < Packing<BITS>::PER; ++k) s += (word >> (k * BITS)) & Packing<BITS>::MASK;
  return s;
}

template <int BITS>
__global__ void fdb_block_sums(const uint32_t* __restrict__ words,
                               uint32_t* __restrict__ sums, long long m) {
  const long long base = (long long)blockIdx.x * Tile<BITS>::WORDS;
  uint32_t s = 0;
  for (int k = threadIdx.x; k < Tile<BITS>::WORDS; k += FTHREADS) {
    const long long j = base + k;
    if (j < m) s += field_sum<BITS>(words[j]);
  }
  uint32_t total;
  block_exclusive_scan<uint32_t>(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void fdb_scan_sums(uint32_t* __restrict__ sums, long long n_blocks) {
  uint32_t carry = 0;
  for (long long c0 = 0; c0 < n_blocks; c0 += blockDim.x) {
    const long long i = c0 + threadIdx.x;
    const uint32_t v = i < n_blocks ? sums[i] : 0u;
    uint32_t total;
    const uint32_t before = block_exclusive_scan<uint32_t>(v, &total);
    if (i < n_blocks) sums[i] = carry + before;
    carry += total;
  }
}

template <typename T, int BITS>
__global__ void fdb_scan_carry(const uint32_t* __restrict__ words,
                               const uint32_t* __restrict__ carry_in,
                               T* __restrict__ out, long long n, long long m) {
  typedef Tile<BITS> TL;
  __shared__ uint32_t wtile[TL::WORDS];
  __shared__ T vtile[TL::VALUES];
  const long long wbase = (long long)blockIdx.x * TL::WORDS;
  for (int k = threadIdx.x; k < TL::WORDS; k += FTHREADS) {
    const long long j = wbase + k;
    wtile[k] = j < m ? words[j] : 0u;
  }
  __syncthreads();
  uint32_t run[TL::VPT];
  uint32_t acc = 0;
#pragma unroll
  for (int q = 0; q < TL::WPT; ++q) {
    const uint32_t word = wtile[threadIdx.x * TL::WPT + q];
#pragma unroll
    for (int k = 0; k < TL::PER; ++k) {
      acc += (word >> (k * BITS)) & Packing<BITS>::MASK;
      run[q * TL::PER + k] = acc;
    }
  }
  uint32_t total;
  const uint32_t before = block_exclusive_scan<uint32_t>(acc, &total) + carry_in[blockIdx.x];
#pragma unroll
  for (int j = 0; j < TL::VPT; ++j) vtile[threadIdx.x * TL::VPT + j] = (T)(before + run[j]);
  __syncthreads();
  const long long vbase = (long long)blockIdx.x * TL::VALUES;
  for (int k = threadIdx.x; k < TL::VALUES; k += FTHREADS) {
    const long long i = vbase + k;
    if (i < n) out[i] = vtile[k];
  }
}

template <int BITS>
static long long decode_blocks(long long n) {
  const long long m = (n + Packing<BITS>::PER - 1) / Packing<BITS>::PER;
  return (m + Tile<BITS>::WORDS - 1) / Tile<BITS>::WORDS;
}

static long long decode_blocks_for(long long n, int bits) {
  switch (bits) {
    case 1: return decode_blocks<1>(n);
    case 2: return decode_blocks<2>(n);
    case 4: return decode_blocks<4>(n);
    case 8: return decode_blocks<8>(n);
    case 16: return decode_blocks<16>(n);
    case 32: return decode_blocks<32>(n);
    default: return -1;
  }
}

template <typename T, int BITS>
static int launch_decode(const void* words, void* out, void* scratch, long long n,
                         cudaStream_t stream) {
  const long long m = (n + Packing<BITS>::PER - 1) / Packing<BITS>::PER;
  const long long n_blocks = decode_blocks<BITS>(n);
  uint32_t* sums = (uint32_t*)scratch;
  fdb_block_sums<BITS><<<(unsigned int)n_blocks, FTHREADS, 0, stream>>>(
      (const uint32_t*)words, sums, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fdb_scan_sums<<<1, 1024, 0, stream>>>(sums, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fdb_scan_carry<T, BITS><<<(unsigned int)n_blocks, FTHREADS, 0, stream>>>(
      (const uint32_t*)words, sums, (T*)out, n, m);
  return (int)cudaGetLastError();
}

// x: n values of `width` bytes -> out: ceil(n * bits / 32) words.
REPRO_API int repro_fused_delta_bitpack(const void* x, void* out, long long n, int width,
                                        int bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_WIDTH_BITS_SWITCH(launch_encode, width, bits, x, out, n, s)
}

// The scratch that repro_fused_delta_bitpack_decode needs for n values at
// `bits`: one uint32 per decode block (-1 for bits outside the choices).  The
// tile size lives here alone; the wrapper asks for the count.
REPRO_API long long repro_fused_delta_bitpack_decode_scratch(long long n, int bits) {
  return decode_blocks_for(n, bits);
}

// words: at least ceil(n * bits / 32) words -> out: n values of `width` bytes.
REPRO_API int repro_fused_delta_bitpack_decode(const void* words, void* out, void* scratch,
                                               long long n_scratch, long long n, int width,
                                               int bits, void* stream) {
  const long long n_blocks = decode_blocks_for(n, bits);
  if (n_blocks < 1 || n_blocks > 0x7FFFFFFFLL || n_scratch < n_blocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_WIDTH_BITS_SWITCH(launch_decode, width, bits, words, out, scratch, n, s)
}
