// K13 — histogram: the 256-bin count of a byte stream, exact at any size.
//
// Replaces the TPU kernel src/repro/kernels/histogram.py, histogram_pallas
// (_hist_kernel), which built the one-hot matrix of each 4096-byte block and
// contracted it with a ones vector on the MXU in float32 — exact only below
// 2^24 counts per bin, which is why the reference's entropy coders took the
// XLA scatter-add histogram_exact instead.  Here the counts are integers
// throughout (u16 per lane, u64 in the output), so the kernel computes the
// exact histogram that Huffman and tANS table construction need, at any size.
//
// Bound: bytes.  The function reads n bytes once and writes 256 counts.
// Design: skewed input — the high byte planes of a column, the exponent
// plane of weights — puts most bytes in one or two bins, and atomics on one
// address serialise.  So no lane shares a counter: every lane of a warp owns
// a private 256-bin histogram of u16 counters in shared memory, laid out
// bin-major with the lane fastest (counter [bin][lane]), so that whatever
// bins the 32 lanes hit, each lane stays in its own bank and an increment is
// a plain conflict-free load-add-store, no atomic.  Skewed and uniform input
// cost the same.  Two warps a block (32 KiB); threads read 16 bytes at a
// time (uint4, coalesced), two loads in flight.  The grid is sized so that
// no lane counts more than 65,535 bytes, so a u16 counter never wraps.  At
// the end each thread sums one bin over its warp's 32 lanes, and the block
// adds each bin to the u64 output with one global atomic.  The bytes before
// the first 16-byte boundary and after the last one (fewer than 32) go one
// per lane through warp 0 of block 0.  The caller zeroes the output.
#include "common.cuh"

#define H_THREADS 64
#define H_WARPS (H_THREADS / 32)
#define H_BLOCKS_CAP (132 * 6)
#define H_LANE_CHUNKS 4095  // 16-byte chunks per lane: 65,520 bytes, under 2^16

__device__ __forceinline__ void count16(unsigned short* __restrict__ h, uint4 q) {
  const unsigned int words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) ++h[((words[k >> 2] >> (8 * (k & 3))) & 0xFFu) << 5];
}

__global__ void histogram_kernel(const uint8_t* __restrict__ x, long long head,
                                 long long n_chunks, long long n,
                                 unsigned long long* __restrict__ out) {
  __shared__ unsigned short hist[H_WARPS * 256 * 32];
  for (int i = threadIdx.x; i < H_WARPS * 256 * 32; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned short* h = hist + warp * 256 * 32 + lane;
  const uint4* body = (const uint4*)(x + head);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; c + stride < n_chunks; c += 2 * stride) {
    const uint4 a = body[c];
    const uint4 b = body[c + stride];
    count16(h, a);
    count16(h, b);
  }
  if (c < n_chunks) count16(h, body[c]);
  if (blockIdx.x == 0 && warp == 0) {
    // the unaligned head [0, head) and the tail [head + 16 n_chunks, n)
    const long long i = lane < head ? lane : head + 16 * n_chunks + (lane - head);
    if (lane < head || i < n) ++h[(unsigned int)x[i] << 5];
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    unsigned long long sum = 0;
    for (int w = 0; w < H_WARPS; ++w)
      for (int l = 0; l < 32; ++l) sum += hist[(w * 256 + b) * 32 + l];
    if (sum) atomicAdd(&out[b], sum);
  }
}

REPRO_API int repro_histogram(const void* x, long long n, void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const uint8_t* p = (const uint8_t*)x;
  long long head = (long long)((16 - ((uintptr_t)p & 15)) & 15);
  if (head > n) head = n;
  const long long n_chunks = (n - head) / 16;
  // enough lanes that none counts more than H_LANE_CHUNKS chunks
  long long blocks = repro_grid(n_chunks, H_THREADS, H_BLOCKS_CAP);
  const long long lanes_needed = (n_chunks + H_LANE_CHUNKS - 1) / H_LANE_CHUNKS;
  if (blocks * H_THREADS < lanes_needed) blocks = (lanes_needed + H_THREADS - 1) / H_THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  histogram_kernel<<<(unsigned int)blocks, H_THREADS, 0, (cudaStream_t)stream>>>(
      p, head, n_chunks, n, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
