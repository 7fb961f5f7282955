// K7 — float split: float bit patterns -> packed sign bits, exponent plane,
// mantissa plane.  K8 — float merge: the inverse.
//
// Replace the TPU kernels src/repro/kernels/float_split.py, float_split_pallas
// (_split_kernel) and float_merge_pallas (_merge_kernel), which split and
// merged u32 patterns only (float32, blocks of 2048) and left the sign as one
// u8 per value for the host to pack.
//
// K7, per value u of the format (exp_bits, man_bits), as the float_split codec
// writes it (src/repro/codecs/floats.py):
//   sign  bit  (u >> (exp_bits + man_bits)) & 1, packed as np.packbits packs:
//              eight values to a byte, the first value in the most significant
//              bit, the tail byte padded with zeros;
//   exp        (u >> man_bits) & (2^exp_bits - 1), u8 (u16 for float64);
//   man        u & (2^man_bits - 1), u8 / u16 / u32 / u64 (bf16 / f16 / f32 / f64).
// K8 computes (sign << (exp_bits + man_bits)) | (exp << man_bits) | man, cut
// to the value's width, without masking the planes, as the codec's decoder
// does.  Both work on unsigned bit patterns only: no value is ever converted
// to a float type, so NaN payloads, infinities, -0.0 and subnormals pass bit
// for bit, and no shift is arithmetic.
//
// Bound: bytes.  K7 reads n*w bytes and writes n*(exp + man) bytes and n/8
// sign bytes; K8 the reverse.  Design: one thread per group of eight
// consecutive values, grid-stride, so a thread owns exactly one sign byte and
// packs it in registers.  The elements are narrow (a bf16 value is two
// bytes), so a thread moves each plane's eight elements with 8- or 16-byte
// vector loads and stores — 16 to 64 bytes of input in flight per thread
// instead of one element — and neighbouring threads touch neighbouring
// addresses.  Vector accesses need aligned planes: the wrapper's outputs are,
// and an input that is not (a slice of a tensor) takes the same kernel with
// element loads (kVec false).  The last group of a length that is not a
// multiple of eight is done element by element.  Templated on the three
// element widths: (2, 1, 1) bfloat16, (2, 1, 2) float16, (4, 1, 4) float32,
// (8, 2, 8) float64.
#include "common.cuh"

// Eight consecutive elements of T (one to eight bytes each) as one value.
template <typename T>
union Group8 {
  T v[8];
  uint2 q2[(8 * sizeof(T) + 7) / 8];
  uint4 q4[(8 * sizeof(T) + 15) / 16];
};

template <typename T, bool kVec>
__device__ __forceinline__ void load8(const T* __restrict__ p, Group8<T>& g) {
  if (kVec && sizeof(T) == 1) {
    g.q2[0] = *(const uint2*)p;
  } else if (kVec) {
#pragma unroll
    for (int k = 0; k < (int)(8 * sizeof(T) / 16); ++k) g.q4[k] = ((const uint4*)p)[k];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) g.v[k] = p[k];
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store8(T* __restrict__ p, const Group8<T>& g) {
  if (kVec && sizeof(T) == 1) {
    *(uint2*)p = g.q2[0];
  } else if (kVec) {
#pragma unroll
    for (int k = 0; k < (int)(8 * sizeof(T) / 16); ++k) ((uint4*)p)[k] = g.q4[k];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = g.v[k];
  }
}

template <typename TIn, typename TExp, typename TMan, bool kVec>
__global__ void float_split_kernel(const TIn* __restrict__ in, uint8_t* __restrict__ sign,
                                   TExp* __restrict__ exp, TMan* __restrict__ man,
                                   long long n, int exp_bits, int man_bits) {
  const long long full = n >> 3;
  const long long groups = (n + 7) >> 3;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned long long exp_mask = (1ull << exp_bits) - 1ull;
  const unsigned long long man_mask = (1ull << man_bits) - 1ull;
  const int sign_shift = exp_bits + man_bits;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const long long i0 = g << 3;
    Group8<TIn> u;
    Group8<TExp> e;
    Group8<TMan> m;
    unsigned int s = 0;
    if (g < full) {
      load8<TIn, kVec>(in + i0, u);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const unsigned long long x = (unsigned long long)u.v[k];
        s |= ((unsigned int)(x >> sign_shift) & 1u) << (7 - k);
        e.v[k] = (TExp)((x >> man_bits) & exp_mask);
        m.v[k] = (TMan)(x & man_mask);
      }
      store8<TExp, kVec>(exp + i0, e);
      store8<TMan, kVec>(man + i0, m);
    } else {  // the last, short group
      for (int k = 0; k < (int)(n - i0); ++k) {
        const unsigned long long x = (unsigned long long)in[i0 + k];
        s |= ((unsigned int)(x >> sign_shift) & 1u) << (7 - k);
        exp[i0 + k] = (TExp)((x >> man_bits) & exp_mask);
        man[i0 + k] = (TMan)(x & man_mask);
      }
    }
    sign[g] = (uint8_t)s;
  }
}

template <typename TOut, typename TExp, typename TMan, bool kVec>
__global__ void float_merge_kernel(const uint8_t* __restrict__ sign,
                                   const TExp* __restrict__ exp,
                                   const TMan* __restrict__ man, TOut* __restrict__ out,
                                   long long n, int exp_bits, int man_bits) {
  const long long full = n >> 3;
  const long long groups = (n + 7) >> 3;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int sign_shift = exp_bits + man_bits;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const long long i0 = g << 3;
    const unsigned int s = sign[g];
    if (g < full) {
      Group8<TExp> e;
      Group8<TMan> m;
      Group8<TOut> u;
      load8<TExp, kVec>(exp + i0, e);
      load8<TMan, kVec>(man + i0, m);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        u.v[k] = (TOut)(((unsigned long long)((s >> (7 - k)) & 1u) << sign_shift) |
                        ((unsigned long long)e.v[k] << man_bits) |
                        (unsigned long long)m.v[k]);
      store8<TOut, kVec>(out + i0, u);
    } else {  // the last, short group
      for (int k = 0; k < (int)(n - i0); ++k)
        out[i0 + k] = (TOut)(((unsigned long long)((s >> (7 - k)) & 1u) << sign_shift) |
                             ((unsigned long long)exp[i0 + k] << man_bits) |
                             (unsigned long long)man[i0 + k]);
    }
  }
}

#define FS_THREADS 256
#define FS_BLOCKS_CAP (132 * 16)

// A group of eight elements of `bytes` bytes each is one vector access.
static inline bool vec_aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)(8 * bytes < 16 ? 8 * bytes : 16)) == 0;
}

template <typename TIn, typename TExp, typename TMan>
static int launch_split(const void* in, void* sign, void* exp, void* man, long long n,
                        int exp_bits, int man_bits, cudaStream_t stream) {
  const unsigned int blocks = repro_grid((n + 7) >> 3, FS_THREADS, FS_BLOCKS_CAP);
  if (vec_aligned(in, sizeof(TIn)) && vec_aligned(exp, sizeof(TExp)) &&
      vec_aligned(man, sizeof(TMan)))
    float_split_kernel<TIn, TExp, TMan, true><<<blocks, FS_THREADS, 0, stream>>>(
        (const TIn*)in, (uint8_t*)sign, (TExp*)exp, (TMan*)man, n, exp_bits, man_bits);
  else
    float_split_kernel<TIn, TExp, TMan, false><<<blocks, FS_THREADS, 0, stream>>>(
        (const TIn*)in, (uint8_t*)sign, (TExp*)exp, (TMan*)man, n, exp_bits, man_bits);
  return (int)cudaGetLastError();
}

template <typename TOut, typename TExp, typename TMan>
static int launch_merge(const void* sign, const void* exp, const void* man, void* out,
                        long long n, int exp_bits, int man_bits, cudaStream_t stream) {
  const unsigned int blocks = repro_grid((n + 7) >> 3, FS_THREADS, FS_BLOCKS_CAP);
  if (vec_aligned(out, sizeof(TOut)) && vec_aligned(exp, sizeof(TExp)) &&
      vec_aligned(man, sizeof(TMan)))
    float_merge_kernel<TOut, TExp, TMan, true><<<blocks, FS_THREADS, 0, stream>>>(
        (const uint8_t*)sign, (const TExp*)exp, (const TMan*)man, (TOut*)out, n, exp_bits,
        man_bits);
  else
    float_merge_kernel<TOut, TExp, TMan, false><<<blocks, FS_THREADS, 0, stream>>>(
        (const uint8_t*)sign, (const TExp*)exp, (const TMan*)man, (TOut*)out, n, exp_bits,
        man_bits);
  return (int)cudaGetLastError();
}

// The element widths (value, exponent, mantissa) of the four formats, as one key.
static inline int widths_key(int width, int exp_width, int man_width) {
  return width * 100 + exp_width * 10 + man_width;
}

REPRO_API int repro_float_split(const void* in, void* sign, void* exp, void* man,
                                long long n, int width, int exp_width, int man_width,
                                int exp_bits, int man_bits, void* stream) {
  if (exp_bits < 1 || man_bits < 1 || exp_bits + man_bits != 8 * width - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (widths_key(width, exp_width, man_width)) {
    case 211: return launch_split<uint16_t, uint8_t, uint8_t>(in, sign, exp, man, n, exp_bits, man_bits, s);
    case 212: return launch_split<uint16_t, uint8_t, uint16_t>(in, sign, exp, man, n, exp_bits, man_bits, s);
    case 414: return launch_split<uint32_t, uint8_t, uint32_t>(in, sign, exp, man, n, exp_bits, man_bits, s);
    case 828: return launch_split<unsigned long long, uint16_t, unsigned long long>(in, sign, exp, man, n, exp_bits, man_bits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

REPRO_API int repro_float_merge(const void* sign, const void* exp, const void* man,
                                void* out, long long n, int width, int exp_width,
                                int man_width, int exp_bits, int man_bits, void* stream) {
  if (exp_bits < 1 || man_bits < 1 || exp_bits + man_bits != 8 * width - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (widths_key(width, exp_width, man_width)) {
    case 211: return launch_merge<uint16_t, uint8_t, uint8_t>(sign, exp, man, out, n, exp_bits, man_bits, s);
    case 212: return launch_merge<uint16_t, uint8_t, uint16_t>(sign, exp, man, out, n, exp_bits, man_bits, s);
    case 414: return launch_merge<uint32_t, uint8_t, uint32_t>(sign, exp, man, out, n, exp_bits, man_bits, s);
    case 828: return launch_merge<unsigned long long, uint16_t, unsigned long long>(sign, exp, man, out, n, exp_bits, man_bits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
