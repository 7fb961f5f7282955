// K16 — entropy-lane window refill: out[i] = the LSB-first 32-bit window of
// `buf` at bit cursor bitpos[i] (uint32 bits in an int32 tensor).
//
// Replaces the TPU kernel src/repro/kernels/lane_refill.py, lane_refill_pallas
// (_refill_kernel), which gathered the five bytes straddling each of 256
// cursors per grid step from the whole bitstream held in VMEM.
//
// In the port the decoders do not refill this way: K15 (Huffman decode) and
// K10 (tANS decode) fetch each lane's bytes ahead of the walk into a ring in
// shared memory (LaneRing, common.cuh) and shift them through a 64-bit bit
// container, so no window is gathered at a cursor on their chain.  This
// launch is the refill on its own, held against its plain version
// (kernels/ref.py lane_refill).
//
// Bound: bytes.  Per cursor it reads 8 bytes of cursor and 5 bytes of
// bitstream and writes 4.  Design: one thread per cursor, grid-stride; the
// cursor reads and window writes are coalesced, the 5-byte gathers go through
// L1 as the cursors fall.
#include "common.cuh"

// The window at bit cursor `bitpos`: the five bytes that straddle it (the
// caller pads `buf` so that five bytes past every cursor are readable),
// stitched as the reference's lane_refill kernel does.  `(b4 << 1) << (31 -
// r)` is b4 << (32 - r) written so that it stays defined at r == 0 (a shift
// by 32 of a 32-bit value is undefined).
__device__ __forceinline__ uint32_t refill32(const uint8_t* __restrict__ buf,
                                             long long bitpos) {
  const uint8_t* p = buf + (bitpos >> 3);
  const uint32_t r = (uint32_t)(bitpos & 7);
  const uint32_t lo = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                      ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  const uint32_t b4 = p[4];
  return (lo >> r) | ((b4 << 1) << (31u - r));
}

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
