// LSB-first packing of PER = 32 / BITS values into each 32-bit word, BITS
// dividing 32, shared by K5/K6 (bitpack.cu) and K11/K12
// (fused_delta_bitpack.cu).  Values are read zero-extended from the unsigned
// type of the stream's width (uint8_t, uint16_t, uint32_t): the wrappers hand
// over PyTorch's uint8/int16/int32 carriers, and reading them through the
// unsigned types never copies a sign bit into a word.
#pragma once

#include "common.cuh"

template <int BITS>
struct Packing {
  static constexpr int PER = 32 / BITS;
  static constexpr uint32_t MASK = 0xFFFFFFFFu >> (32 - BITS);
};

// Word `w` of the packing of x[0..n): the sum of x[w*PER + k] << (k*BITS)
// mod 2^32, as the reference sums its shifted values (the bitwise OR when
// every value fits BITS); slots past n are 0.
template <typename T, int BITS>
__device__ __forceinline__ uint32_t pack_word(const T* __restrict__ x, long long w,
                                              long long n) {
  constexpr int PER = Packing<BITS>::PER;
  const long long i0 = w * PER;
  uint32_t acc = 0;
  if (i0 + PER <= n) {
#pragma unroll
    for (int k = 0; k < PER; ++k) acc += (uint32_t)x[i0 + k] << (k * BITS);
  } else {
    for (int k = 0; i0 + k < n; ++k) acc += (uint32_t)x[i0 + k] << (k * BITS);
  }
  return acc;
}

// Returns F<T, BITS>(args) for the stream width (1, 2, 4 bytes) and BITS in
// {1, 2, 4, 8, 16, 32}; any other pair returns BAD (the _TO forms) or
// cudaErrorInvalidValue.
#define REPRO_BITS_SWITCH_TO(F, BAD, T, bits, ...) \
  switch (bits) {                                  \
    case 1: return F<T, 1>(__VA_ARGS__);           \
    case 2: return F<T, 2>(__VA_ARGS__);           \
    case 4: return F<T, 4>(__VA_ARGS__);           \
    case 8: return F<T, 8>(__VA_ARGS__);           \
    case 16: return F<T, 16>(__VA_ARGS__);         \
    case 32: return F<T, 32>(__VA_ARGS__);         \
    default: return BAD;                           \
  }
#define REPRO_WIDTH_BITS_SWITCH_TO(F, BAD, width, bits, ...)              \
  switch (width) {                                                       \
    case 1: REPRO_BITS_SWITCH_TO(F, BAD, uint8_t, bits, __VA_ARGS__)     \
    case 2: REPRO_BITS_SWITCH_TO(F, BAD, uint16_t, bits, __VA_ARGS__)    \
    case 4: REPRO_BITS_SWITCH_TO(F, BAD, uint32_t, bits, __VA_ARGS__)    \
    default: return BAD;                                                 \
  }
#define REPRO_WIDTH_BITS_SWITCH(F, width, bits, ...) \
  REPRO_WIDTH_BITS_SWITCH_TO(F, (int)cudaErrorInvalidValue, width, bits, __VA_ARGS__)
