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
