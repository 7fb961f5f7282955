// K16 — entropy-lane window refill: out[i] = the LSB-first 32-bit window of
// `buf` at bit cursor bitpos[i] (uint32 bits in an int32 tensor).
//
// Replaces the TPU kernel src/repro/kernels/lane_refill.py, lane_refill_pallas
// (_refill_kernel), which gathered the five bytes straddling each of 256
// cursors per grid step from the whole bitstream held in VMEM.
//
// In the port the refill is not a pass of its own: refill32 (common.cuh) is a
// __device__ function that the Huffman (K15) and tANS (K10) decode kernels
// call at every step, so the window never goes through device memory.  This
// launch applies the same function to a vector of cursors, so that it can be
// held against its plain version (kernels/ref.py lane_refill).
//
// Bound: bytes.  Per cursor it reads 8 bytes of cursor and 5 bytes of
// bitstream and writes 4.  Design: one thread per cursor, grid-stride; the
// cursor reads and window writes are coalesced, the 5-byte gathers go through
// L1 as the cursors fall.
#include "common.cuh"

__global__ void lane_refill_kernel(const uint8_t* __restrict__ buf,
                                   const long long* __restrict__ bitpos,
                                   uint32_t* __restrict__ out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = refill32(buf, bitpos[i]);
}

REPRO_API int repro_lane_refill(const void* buf, const void* bitpos, void* out,
                                long long n, void* stream) {
  const int threads = 256;
  lane_refill_kernel<<<repro_grid(n, threads, 132 * 16), threads, 0,
                       (cudaStream_t)stream>>>((const uint8_t*)buf,
                                               (const long long*)bitpos,
                                               (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
