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

// K15 — Huffman decode: every 4096-symbol lane walks its own bit cursor
// through the canonical LSB-first bitstream and emits one symbol per code.
//
// Replaces the TPU kernel src/repro/kernels/huffman.py, huffman_decode_pallas
// (_decode_kernel), which ran 256 lanes per grid step as vector lanes with an
// int32 cursor and one symbol per 32-bit refill.
//
// Per step a lane takes the 32-bit window at its cursor (refill32, the K16
// body in common.cuh), looks its low 15 bits up in the decode LUT, emits the
// symbol and advances by the code length.  A code is at most 15 bits, so one
// 32-bit window always holds two whole codes: the kernel decodes two symbols
// per refill.  The symbols are those of the one-per-refill walk (the decode is
// a function of the bits alone), so the plain version (kernels/ref.py
// huffman_decode_lanes, one per refill as the reference) agrees on every row.
//
// Bound: latency.  The wire fixes 4096 symbols per lane, so a 2^26-symbol
// stream is 16,384 lanes of 4096 dependent steps — about 6 % of the card's
// resident threads — and each step waits on a global load and a shared-memory
// lookup.  Design: the LUT is 2^15 entries packed as u16 (symbol | length << 8),
// 64 KiB of dynamic shared memory (above the 48 KB default, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize), copied in 16-byte loads by
// each block; 64 threads per block spread the lanes over every SM.  Cursors
// are int64 (the wire's block offsets are u64).  The output is the
// (max_rem, n_lanes) plane layout, so each step's stores are coalesced across
// the warp; K4 puts it back into symbol order.  The caller pads the bitstream
// with zeros by 16 + (15 * max_rem + 7) / 8 bytes, so the surplus rows of a
// short last lane decode zeros and never read out of bounds.
#define HUFF_LUT_ENTRIES (1 << 15)

__global__ void huffman_decode_kernel(const uint8_t* __restrict__ buf,
                                      const long long* __restrict__ pos0,
                                      const uint16_t* __restrict__ lut,
                                      uint8_t* __restrict__ out, int max_rem,
                                      long long n_lanes) {
  extern __shared__ uint4 s_lut4[];
  const uint16_t* s_lut = (const uint16_t*)s_lut4;
  const uint4* g = (const uint4*)lut;
  for (int i = threadIdx.x; i < HUFF_LUT_ENTRIES * 2 / 16; i += blockDim.x) s_lut4[i] = g[i];
  __syncthreads();
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  long long pos = pos0[lane];
  uint8_t* o = out + lane;
  int i = 0;
  for (; i + 1 < max_rem; i += 2) {
    uint32_t win = refill32(buf, pos);
    const uint32_t e0 = s_lut[win & 0x7FFFu];
    win >>= (e0 >> 8);
    const uint32_t e1 = s_lut[win & 0x7FFFu];
    o[(long long)i * n_lanes] = (uint8_t)e0;
    o[(long long)(i + 1) * n_lanes] = (uint8_t)e1;
    pos += (e0 >> 8) + (e1 >> 8);
  }
  if (i < max_rem) o[(long long)i * n_lanes] = (uint8_t)s_lut[refill32(buf, pos) & 0x7FFFu];
}

REPRO_API int repro_huffman_decode(const void* buf, const void* pos, const void* lut,
                                   void* out, int max_rem, long long n_lanes,
                                   void* stream) {
  const int threads = 64;
  const int smem = HUFF_LUT_ENTRIES * 2;
  cudaError_t err = cudaFuncSetAttribute(
      huffman_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_lanes + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  huffman_decode_kernel<<<(unsigned int)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const long long*)pos, (const uint16_t*)lut, (uint8_t*)out,
      max_rem, n_lanes);
  return (int)cudaGetLastError();
}
