// K5 — bitpack: pack PER = 32 / bits values of a uint8/uint16/uint32 stream
// into each 32-bit word, LSB-first; bits in {1, 2, 4, 8, 16, 32}.
//
// Replaces the TPU kernel src/repro/kernels/bitpack.py, bitpack_pallas
// (_pack_kernel), which packed 512 words per grid step from a u32 input that
// the wrapper had widened and zero-padded to the block.
//
// Bound: bytes.  The function reads n*w bytes and writes n*bits/8 bytes.
// Design: each thread writes one 16-byte vector of four words.  It reads the
// 4*PER values behind them at the stream's own width (zero-extended, so a
// uint8 column moves n bytes, not the reference's 4n) as 16-byte vectors (8
// or 4 bytes where the four words take fewer input bytes), and loads and
// stores are streaming (ld/st.global.cs: each byte is touched once).  At 32
// bits the kernel is a vectorised copy; at 4 bits on a uint8 column a thread
// makes two 16-byte loads.  The host takes that path when the input is
// aligned to the vector; an input view at an offset, and the last thread's
// words past the last full vector, read their values one at a time
// (pack_word).  Slots of the last word past n are 0, so no input padding
// and no tail mask are needed.  Templated on (width, bits), as K1 is on
// width.
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

// How a K5 thread reads the 4*PER values of its four words: BYTES input
// bytes, loaded CHUNK bytes at a time (all at once up to 64 bytes, else one
// word's values at a time, to bound the registers) in vectors of VEC bytes.
template <typename T, int BITS>
struct PackLoad {
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int BYTES = 4 * PER * (int)sizeof(T);
  static constexpr int WORDS_PER_CHUNK = BYTES <= 64 ? 4 : 1;
  static constexpr int CHUNK = BYTES / 4 * WORDS_PER_CHUNK;
  static constexpr int VEC = CHUNK < 16 ? CHUNK : 16;
};

// N_REGS 32-bit registers from `src`, aligned to VEC bytes, as streaming
// loads (ld.global.cs: each input byte is read once).
template <int VEC, int N_REGS>
__device__ __forceinline__ void load_regs(const uint8_t* __restrict__ src, uint32_t* r) {
  if constexpr (VEC == 16) {
#pragma unroll
    for (int v = 0; v < N_REGS / 4; ++v) {
      const uint4 a = __ldcs(reinterpret_cast<const uint4*>(src) + v);
      r[4 * v] = a.x;
      r[4 * v + 1] = a.y;
      r[4 * v + 2] = a.z;
      r[4 * v + 3] = a.w;
    }
  } else if constexpr (VEC == 8) {
    const uint2 a = __ldcs(reinterpret_cast<const uint2*>(src));
    r[0] = a.x;
    r[1] = a.y;
  } else {
    r[0] = __ldcs(reinterpret_cast<const unsigned int*>(src));
  }
}

// The four words of x[0 .. 4*PER), read as vectors (x aligned to VEC bytes).
template <typename T, int BITS>
__device__ __forceinline__ uint4 pack4(const T* __restrict__ x) {
  using L = PackLoad<T, BITS>;
  constexpr int PER = L::PER;
  constexpr int VPR = 4 / (int)sizeof(T);  // values per register
  constexpr int TBITS = 8 * (int)sizeof(T);
  constexpr uint32_t TMASK = 0xFFFFFFFFu >> (32 - TBITS);
  uint32_t word[4];
#pragma unroll
  for (int c = 0; c < 4 / L::WORDS_PER_CHUNK; ++c) {
    uint32_t r[L::CHUNK / 4];
    load_regs<L::VEC, L::CHUNK / 4>(reinterpret_cast<const uint8_t*>(x) + c * L::CHUNK, r);
#pragma unroll
    for (int j = 0; j < L::WORDS_PER_CHUNK; ++j) {
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = j * PER + k;  // value index within the chunk
        acc += ((r[i / VPR] >> ((i % VPR) * TBITS)) & TMASK) << (k * BITS);
      }
      word[c * L::WORDS_PER_CHUNK + j] = acc;
    }
  }
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// Thread t writes words 4t..4t+3, one 16-byte output vector (no loop).
template <typename T, int BITS, bool VECTOR>
__global__ void bitpack_kernel(const T* __restrict__ x, uint32_t* __restrict__ out,
                               long long n, long long m) {
  constexpr int PER = Packing<BITS>::PER;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long w0 = 4 * t;
  if (w0 >= m) return;
  if (VECTOR && (w0 + 4) * PER <= n) {
    __stcs(reinterpret_cast<uint4*>(out) + t, pack4<T, BITS>(x + w0 * PER));
  } else if (w0 + 4 <= m) {
    reinterpret_cast<uint4*>(out)[t] =
        make_uint4(pack_word<T, BITS>(x, w0, n), pack_word<T, BITS>(x, w0 + 1, n),
                   pack_word<T, BITS>(x, w0 + 2, n), pack_word<T, BITS>(x, w0 + 3, n));
  } else {
    for (long long w = w0; w < m; ++w) out[w] = pack_word<T, BITS>(x, w, n);
  }
}

// out must be 16-byte aligned (a fresh allocation); x may start anywhere.
template <typename T, int BITS>
static int launch_pack(const void* x, void* out, long long n, cudaStream_t stream) {
  const long long m = (n + Packing<BITS>::PER - 1) / Packing<BITS>::PER;
  const long long quads = (m + 3) / 4;
  const int threads = 256;
  if ((quads + threads - 1) / threads > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = repro_grid(quads, threads, 0x7FFFFFFFLL);
  if ((uintptr_t)x % PackLoad<T, BITS>::VEC == 0)
    bitpack_kernel<T, BITS, true><<<blocks, threads, 0, stream>>>((const T*)x, (uint32_t*)out,
                                                                  n, m);
  else
    bitpack_kernel<T, BITS, false><<<blocks, threads, 0, stream>>>((const T*)x, (uint32_t*)out,
                                                                   n, m);
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
