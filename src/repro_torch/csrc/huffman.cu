// K14 — Huffman symbol map: per byte symbol, its canonical code (LSB-first,
// bit-reversed as the wire writes it) and its code length, from 256-entry tables.
//
// Replaces the TPU kernel src/repro/kernels/huffman.py, huffman_map_pallas
// (_map_kernel), which gathered from the whole tables per 2048-symbol block.
//
// Bound: bytes.  Per symbol it reads 1 byte and writes 8 (an int32 code and an
// int32 length); the table lookups are on-chip.  Design: each block copies the
// two 1 KiB tables into shared memory once, then walks its share of the
// stream with a grid-stride loop, so the lookups never touch device memory
// and the stream is read and written coalesced.  The exclusive cumsum of the
// lengths and the bit packer stay PyTorch glue on the card (kernels/ref.py).
#include "common.cuh"

__global__ void huffman_map_kernel(const uint8_t* __restrict__ x,
                                   const int* __restrict__ codes,
                                   const int* __restrict__ lens,
                                   int* __restrict__ code, int* __restrict__ nbits,
                                   long long n) {
  __shared__ int s_codes[256];
  __shared__ int s_lens[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_codes[i] = codes[i];
    s_lens[i] = lens[i];
  }
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = x[i];
    code[i] = s_codes[s];
    nbits[i] = s_lens[s];
  }
}

REPRO_API int repro_huffman_map(const void* x, const void* codes, const void* lens,
                                void* code, void* nbits, long long n, void* stream) {
  const int threads = 256;
  huffman_map_kernel<<<repro_grid(n, threads, 132 * 16), threads, 0,
                       (cudaStream_t)stream>>>((const uint8_t*)x, (const int*)codes,
                                               (const int*)lens, (int*)code,
                                               (int*)nbits, n);
  return (int)cudaGetLastError();
}
