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
// Bound: bytes.  Reads n*bits/8 bytes, writes n*w bytes.  Design: the
// mirror of K5.  A thread reads G words (four, or as many as give 16 output
// bytes: 32 bits to uint8 takes sixteen) as 16-byte streaming vectors and
// writes their G*PER values as 16-byte streaming vectors (ld/st.global.cs),
// so at 32 bits to int32 the kernel is a vectorised copy.  Where a thread's
// values fill 2, 4 or 8 vectors (at 4 bits to uint8, two), its warp stages
// them through shared memory and stores 512 contiguous bytes per
// instruction: vectors stored at the stride of a thread's output leave each
// 32-byte sector half written per instruction, which ran up to 1.7 times
// slower on an H100.  Words may start at any 4-byte boundary (a view into a
// frame's payload): the host then takes the shifted path, whose lanes join
// the two aligned vectors around their words (load_run in common.cuh).
// Only the last, partial group takes the scalar tail.
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

// How a K6 thread covers its words: G of them (V = G / 4 16-byte input
// vectors), whose values fill NV 16-byte output vectors.  Four words where
// they give at least 16 output bytes, else as many as give 16 (at 32 bits
// to uint8, sixteen words).
template <typename T, int BITS>
struct UnpackGroup {
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int WORD_BYTES = PER * (int)sizeof(T);  // output bytes of one word
  static constexpr int G = WORD_BYTES >= 4 ? 4 : 16 / WORD_BYTES;
  static constexpr int V = G / 4;
  static constexpr int NV = G * WORD_BYTES / 16;
};

// Output vector v of a group of G words: values 4v*VPR .. of the group.
template <typename T, int BITS>
__device__ __forceinline__ uint4 unpack_vector(const uint32_t* wd, int v) {
  constexpr int PER = Packing<BITS>::PER;
  constexpr int VPR = 4 / (int)sizeof(T);  // values per register
  constexpr int TBITS = 8 * (int)sizeof(T);
  constexpr uint32_t MASK = Packing<BITS>::MASK & (0xFFFFFFFFu >> (32 - TBITS));
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t acc = 0;
#pragma unroll
    for (int q = 0; q < VPR; ++q) {
      const int i = (4 * v + j) * VPR + q;  // value index within the group
      acc |= ((wd[i / PER] >> ((i % PER) * BITS)) & MASK) << (q * TBITS);
    }
    r[j] = acc;
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Thread t unpacks words G*t .. G*t + G - 1 into values G*t*PER onwards.  A
// warp of full groups with 2, 4 or 8 vectors each stages them (stage_slot
// in common.cuh); otherwise a full group stores its NV vectors, each
// assembled in four registers just before its store, so at most one
// vector's values are live (at 1 bit to uint32 a thread stores 512 bytes).
// The last, partial group reads its words and stores its values one at a
// time, up to n.
template <typename T, int BITS, bool SHIFTED>
__global__ void __launch_bounds__(256)
bitunpack_kernel(const uint32_t* __restrict__ words, T* __restrict__ out, long long n,
                 long long m) {
  using U = UnpackGroup<T, BITS>;
  constexpr int PER = U::PER;
  const long long w0 = U::G * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  const bool full = (w0 + U::G) * PER <= n;
  uint32_t wd[U::G];
  load_run<U::V, SHIFTED>(reinterpret_cast<const uint8_t*>(words + w0),
                          reinterpret_cast<const uint8_t*>(words + m), full, wd);
  constexpr bool STAGE = U::NV == 2 || U::NV == 4 || U::NV == 8;
  if constexpr (STAGE) {
    __shared__ uint4 stage[8][32 * (STAGE ? U::NV : 1)];
    if (__all_sync(0xffffffffu, full)) {  // the warp's 32*NV vectors, staged
      const int lane = threadIdx.x & 31;
      uint4* st = stage[threadIdx.x >> 5];
#pragma unroll
      for (int v = 0; v < U::NV; ++v)
        st[stage_slot(lane * U::NV + v)] = unpack_vector<T, BITS>(wd, v);
      __syncwarp();
      uint4* dst = reinterpret_cast<uint4*>(out + (w0 - (long long)U::G * lane) * PER);
#pragma unroll
      for (int k = 0; k < U::NV; ++k) __stcs(dst + 32 * k + lane, st[stage_slot(32 * k + lane)]);
      return;
    }
  }
  if (full) {
    uint4* dst = reinterpret_cast<uint4*>(out + w0 * PER);
#pragma unroll
    for (int v = 0; v < U::NV; ++v) __stcs(dst + v, unpack_vector<T, BITS>(wd, v));
  } else if (w0 < m) {
    for (long long w = w0; w < m && w < w0 + U::G; ++w) {
      const uint32_t word = words[w];
      for (int k = 0; k < PER && w * PER + k < n; ++k)
        out[w * PER + k] = (T)((word >> (k * BITS)) & Packing<BITS>::MASK);
    }
  }
}

// words need 4-byte alignment (an int32 tensor's), out 16 (a fresh allocation).
template <typename T, int BITS>
static int launch_unpack(const void* words, void* out, long long n, cudaStream_t stream) {
  using U = UnpackGroup<T, BITS>;
  const long long m = (n + U::PER - 1) / U::PER;
  const long long groups = (m + U::G - 1) / U::G;
  const int threads = 256;
  if ((uintptr_t)words % 4 || (uintptr_t)out % 16 ||
      (groups + threads - 1) / threads > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const unsigned int blocks = repro_grid(groups, threads, 0x7FFFFFFFLL);
  if ((uintptr_t)words % 16 == 0)
    bitunpack_kernel<T, BITS, false><<<blocks, threads, 0, stream>>>((const uint32_t*)words,
                                                                     (T*)out, n, m);
  else
    bitunpack_kernel<T, BITS, true><<<blocks, threads, 0, stream>>>((const uint32_t*)words,
                                                                    (T*)out, n, m);
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
