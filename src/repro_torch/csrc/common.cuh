// Shared helpers for the port's CUDA kernels (built with nvcc for sm_90a into
// one shared library with a plain C interface, loaded with ctypes).
//
// Conventions: kernels allocate nothing (the Python wrapper allocates with
// torch.empty and checks device, dtype, contiguity and shape), launch on the
// stream they are given, never synchronise, and every C entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// Blocks for a grid-stride loop over n items: enough to fill the card many
// times over, few enough that per-block set-up (table loads) is amortised.
static inline unsigned int repro_grid(long long n, int threads, long long cap) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (unsigned int)blocks;
}

// K16's body: the LSB-first 32-bit window of `buf` at bit cursor `bitpos`.
//
// Reads the five bytes that straddle the cursor (the caller pads `buf` so
// that five bytes past every cursor are readable) and stitches them as the
// reference's lane_refill kernel does.  `(b4 << 1) << (31 - r)` is
// b4 << (32 - r) written so that it stays defined at r == 0 (a shift by 32 of
// a 32-bit value is undefined).  K15 (Huffman decode) and K10 (tANS decode)
// call it for every refill; csrc/lane_refill.cu launches it on its own.
__device__ __forceinline__ uint32_t refill32(const uint8_t* __restrict__ buf,
                                             long long bitpos) {
  const uint8_t* p = buf + (bitpos >> 3);
  const uint32_t r = (uint32_t)(bitpos & 7);
  const uint32_t lo = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                      ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  const uint32_t b4 = p[4];
  return (lo >> r) | ((b4 << 1) << (31u - r));
}

// Exclusive prefix of v over the block (blockDim a multiple of 32, at most
// 1024); *total receives the block's sum.  Every thread must call it.  The
// carry designs of K2 (delta.cu) and K12 (fused_delta_bitpack.cu) share it.
template <typename A>
__device__ __forceinline__ A block_exclusive_scan(A v, A* total) {
  __shared__ A warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  A x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const A y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    A s = lane < n_warps ? warp_sums[lane] : (A)0;
    for (int o = 1; o < 32; o <<= 1) {
      const A y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const A before = wid ? warp_sums[wid - 1] : (A)0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}
