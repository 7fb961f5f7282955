// K5 — bitpack: pack PER = 32 / bits values of a uint8/uint16/uint32 stream
// into each 32-bit word, LSB-first; bits in {1, 2, 4, 8, 16, 32}.
//
// Replaces the TPU kernel src/repro/kernels/bitpack.py, bitpack_pallas
// (_pack_kernel), which packed 512 words per grid step from a u32 input that
// the wrapper had widened and zero-padded to the block.
//
// Bound: bytes.  The function reads n*w bytes and writes n*bits/8 bytes.
// Design: one thread per output word, in a grid-stride loop; the thread reads
// its PER values at the stream's own width (zero-extended, so a uint8 column
// moves n bytes, not the reference's 4n) and writes one word.  Slots of the
// last word past n are 0, so no input padding and no tail mask are needed.
// Templated on (width, bits), as K1 is on width.
//
// K6 — bitunpack: the inverse, value i = (word[i / PER] >> (i % PER)*bits)
// & mask, stored at the output width (truncated, as the reference's astype).
//
// Replaces src/repro/kernels/bitpack.py, bitunpack_pallas (_unpack_kernel).
//
// Bound: bytes.  Reads n*bits/8 bytes, writes n*w bytes.  Design: one thread
// per word, which writes its PER values: where they fill whole 32-bit
// registers (a u8 column at 4 bits: 8 bytes), they are assembled in
// registers and stored as one 16-, 8- or 4-byte vector, where one thread
// per value would store a single byte per thread for a u8 column.
#include "bitpack.cuh"

template <typename T, int BITS>
__global__ void bitpack_kernel(const T* __restrict__ x, uint32_t* __restrict__ out,
                               long long n, long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < m; w += stride)
    out[w] = pack_word<T, BITS>(x, w, n);
}

template <typename T, int BITS>
static int launch_pack(const void* x, void* out, long long n, cudaStream_t stream) {
  const long long m = (n + Packing<BITS>::PER - 1) / Packing<BITS>::PER;
  const int threads = 256;
  bitpack_kernel<T, BITS><<<repro_grid(m, threads, 1LL << 20), threads, 0, stream>>>(
      (const T*)x, (uint32_t*)out, n, m);
  return (int)cudaGetLastError();
}

// The PER values of `word`, cut to T, stored at out[0..PER).  Where they fill
// whole 32-bit registers, the values are assembled in registers and stored
// 16, 8 or 4 bytes at a time (out is aligned to the chunk: word j's values
// start at byte j * PER * sizeof(T) of a fresh allocation).
template <typename T, int BITS>
__device__ __forceinline__ void unpack_word(T* __restrict__ out, uint32_t word) {
  constexpr int PER = Packing<BITS>::PER;
  constexpr int BYTES = PER * (int)sizeof(T);
  constexpr uint32_t MASK = Packing<BITS>::MASK;
  if constexpr (BYTES % 4 == 0) {
    constexpr int R = BYTES / 4;              // 32-bit registers of values
    constexpr int VPR = 4 / (int)sizeof(T);   // values per register
    constexpr int TBITS = 8 * (int)sizeof(T);
    constexpr uint32_t TMASK = 0xFFFFFFFFu >> (32 - TBITS);
    uint32_t reg[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t v = 0;
#pragma unroll
      for (int q = 0; q < VPR; ++q)
        v |= ((word >> ((r * VPR + q) * BITS)) & MASK & TMASK) << (q * TBITS);
      reg[r] = v;
    }
    if constexpr (R % 4 == 0) {
#pragma unroll
      for (int g = 0; g < R / 4; ++g)
        reinterpret_cast<uint4*>(out)[g] =
            make_uint4(reg[4 * g], reg[4 * g + 1], reg[4 * g + 2], reg[4 * g + 3]);
    } else if constexpr (R == 2) {
      reinterpret_cast<uint2*>(out)[0] = make_uint2(reg[0], reg[1]);
    } else {
      reinterpret_cast<uint32_t*>(out)[0] = reg[0];
    }
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k) out[k] = (T)((word >> (k * BITS)) & MASK);
  }
}

template <typename T, int BITS>
__global__ void bitunpack_kernel(const uint32_t* __restrict__ words, T* __restrict__ out,
                                 long long n, long long m) {
  constexpr int PER = Packing<BITS>::PER;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < m; w += stride) {
    const uint32_t word = words[w];
    const long long i0 = w * PER;
    if (i0 + PER <= n) {
      unpack_word<T, BITS>(out + i0, word);
    } else {
      for (int k = 0; i0 + k < n; ++k)
        out[i0 + k] = (T)((word >> (k * BITS)) & Packing<BITS>::MASK);
    }
  }
}

template <typename T, int BITS>
static int launch_unpack(const void* words, void* out, long long n, cudaStream_t stream) {
  const long long m = (n + Packing<BITS>::PER - 1) / Packing<BITS>::PER;
  const int threads = 256;
  bitunpack_kernel<T, BITS><<<repro_grid(m, threads, 1LL << 20), threads, 0, stream>>>(
      (const uint32_t*)words, (T*)out, n, m);
  return (int)cudaGetLastError();
}

// x: n values of `width` bytes -> out: ceil(n * bits / 32) words.
REPRO_API int repro_bitpack(const void* x, void* out, long long n, int width, int bits,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_WIDTH_BITS_SWITCH(launch_pack, width, bits, x, out, n, s)
}

// words: at least ceil(n * bits / 32) words -> out: n values of `width` bytes.
REPRO_API int repro_bitunpack(const void* words, void* out, long long n, int width,
                              int bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_WIDTH_BITS_SWITCH(launch_unpack, width, bits, words, out, n, s)
}
