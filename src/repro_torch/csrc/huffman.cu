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

// K15 — Huffman decode: every lane (4096 symbols on the wire) walks its own
// bit cursor through the canonical LSB-first bitstream and emits one symbol
// per code.
//
// Replaces the TPU kernel src/repro/kernels/huffman.py, huffman_decode_pallas
// (_decode_kernel), which ran 256 lanes per grid step as vector lanes with an
// int32 cursor and one symbol per 32-bit refill.
//
// The plain version (kernels/ref.py huffman_decode_lanes) looks the low 15
// bits of the 32-bit window at the cursor up in the 2^15-entry LUT, emits
// the symbol and advances by the code's length (0 for unused code space:
// the cursor stays).  The symbols are a function of the bits alone, so the
// kernel may bring the bits on chip any way it likes and still agree on
// every row.
//
// Bound: latency.  A 2^26-symbol stream is 16,384 lanes of 4096 dependent
// steps, one warp per scheduler of the card, so a step's time is its chain's
// latency.  Design: nothing on a lane's chain reads device memory.
// - Bits fetched ahead.  Each lane's bytes come into its LaneRing
//   (common.cuh) of HUFF_RING 16-byte slots by cp.async.  Every HUFF_ROUND
//   steps every lane tops its ring up, commits and waits for all but the
//   last HUFF_PENDING rounds' copies.  A step takes at most one word from
//   the ring, so a vector issued at a round is first read at least
//   4 * HUFF_RING - 11 steps later, after HUFF_PENDING + 1 more rounds: its
//   copy has landed (the static_assert below).
// - A 64-bit bit container (lo, hi) holds the bits from the one before the
//   cursor on (a junk bit, so that an entry's byte offset in the LUT is one
//   AND of the container), at least 32 at a step's start.  A step looks the
//   bits up, shifts the container by the code's length, and when fewer than
//   32 remain ORs in the ring's next word at bit avail (17 to 31).  That word
//   was read from the ring a step before, and its bits land above bit 16, so
//   the next lookup reads the shifted container without waiting for the
//   refill: the chain is an AND, one shared load and one funnel shift.  The
//   step has no branch, so a round of HUFF_ROUND steps tops the ring up with
//   at most HUFF_ROUND / 4 copies.
// - The LUT.  A canonical LSB-first LUT whose longest code has L bits is
//   periodic in 2^L: lut[i] == lut[i & (2^L - 1)].  So each block copies only
//   its first 2^lut_log entries (the least period, found by the wrapper,
//   ops.huffman_lut_log; at least 8) and repacks them as len | sym << 8, so
//   that a funnel shift by the entry, which takes its low five bits, shifts
//   by the length.
// - Reads stay inside `buf`.  A ring copy of a vector that holds no byte of
//   the allocation writes zeros and reads nothing, so the read-ahead is
//   clamped to the allocation and the glue's padding (16 + (15 * max_rem +
//   7) / 8 zero bytes, entropy.huffman_lanes) is unchanged.  The bits a step
//   uses lie inside the padded buffer, as the plain version's do; lane
//   starts may be in any order, overlap or lie at the buffer's end, since
//   each lane fetches its own bytes.
// - Stores go straight from the walk into the (max_rem, n_lanes) plane
//   layout, 32 contiguous bytes a warp a row; K4 puts them back into symbol
//   order.
#define HUFF_LANES 128  // lanes (threads) per block
#define HUFF_RING 16    // 16-byte slots in a lane's ring
#define HUFF_ROUND 8    // steps between two rounds of ring copies
#define HUFF_PENDING 5  // rounds whose copies may be in flight after a round's wait
#define HUFF_RING_BYTES (HUFF_LANES * HUFF_RING * 16)
static_assert((4 * HUFF_RING - 11) / HUFF_ROUND >= HUFF_PENDING + 1,
              "a ring vector must land before a lane can reach it");

__global__ void __launch_bounds__(HUFF_LANES)
huffman_decode_kernel(const uint8_t* __restrict__ buf, long long n_bytes,
                      const long long* __restrict__ pos0, const uint16_t* __restrict__ lut,
                      int lut_log, uint8_t* __restrict__ out, int max_rem, long long n_lanes) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem + HUFF_RING_BYTES);
  const int t = threadIdx.x;
  for (int i = t; i < (1 << lut_log) / 8; i += HUFF_LANES) {
    uint4 v = reinterpret_cast<const uint4*>(lut)[i];
    v.x = __byte_perm(v.x, 0, 0x2301);  // sym | len << 8 -> len | sym << 8
    v.y = __byte_perm(v.y, 0, 0x2301);
    v.z = __byte_perm(v.z, 0, 0x2301);
    v.w = __byte_perm(v.w, 0, 0x2301);
    reinterpret_cast<uint4*>(s_lut)[i] = v;
  }
  const long long lane = (long long)blockIdx.x * HUFF_LANES + t;
  const bool live = lane < n_lanes;
  const uint8_t* end = buf + n_bytes;
  const long long p = live ? pos0[lane] : 0;
  const uint8_t* first = buf + (p >> 3);
  LaneRing<HUFF_RING, true> ring{reinterpret_cast<uint32_t*>(smem) + 4 * HUFF_RING * t,
                                 (const uint8_t*)((uintptr_t)first & ~(uintptr_t)15), t & 7u, 0};
  if (live) ring.fill<HUFF_RING>(0, buf, end);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the LUT is in place
  if (!live) return;

  // The container: the bits from the one before the lane's first bit on.
  // That bit is junk, so the LUT's byte offset is one AND of the container.
  const unsigned sbit = (unsigned)((((uintptr_t)first & 15) << 3) | (p & 7));
  uint32_t lo, hi;
  unsigned d;  // the next ring word to go in
  int avail;   // bits held, the junk one included; those above are zero
  // (at most 63, so that a refill is avail |= 32: one word where two would
  // fill the container)
  if (sbit) {
    const unsigned r = (sbit - 1) & 31;
    d = (sbit - 1) >> 5;
    const uint32_t w1 = r ? ring.word(ring.index(d + 1)) : 0u;
    lo = __funnelshift_r(ring.word(ring.index(d)), w1, r);
    hi = w1 >> r;
    avail = r ? 64 - (int)r : 32;
    d += r ? 2 : 1;
  } else {
    lo = ring.word(ring.index(0)) << 1;
    hi = ring.word(ring.index(0)) >> 31;
    avail = 33;
    d = 1;
  }
  unsigned wi = ring.index(d);
  uint32_t w_next = ring.word(wi);
  uint32_t peek = lo;  // the container's low bits, before the last refill
  const uint32_t offsets = ((1u << lut_log) - 1u) << 1;  // an entry's byte offset
  const uint8_t* lut_bytes = reinterpret_cast<const uint8_t*>(s_lut);
  uint8_t* o = out + lane;

  // Step j of a round, without a branch: every step reads the ring's next
  // word for the next one (a load issued only where a refill needs it would
  // be waited for at once).  The funnel shifts take their amount mod 32.
  auto step = [&](int j) {
    const uint32_t e = *reinterpret_cast<const uint16_t*>(lut_bytes + (peek & offsets));
    peek = __funnelshift_r(lo, hi, e);  // >> length (the entry's low five bits)
    hi = __funnelshift_r(hi, 0u, e);
    avail -= (int)(e & 31u);
    const uint32_t w = avail < 32 ? w_next : 0u;  // a refill, at bit 17..31
    lo = peek | __funnelshift_l(0u, w, avail);     // w << avail
    hi |= __funnelshift_l(w, 0u, avail);           // w >> (32 - avail)
    wi += avail < 32;
    avail |= 32;
    w_next = ring.word(wi);
    o[(long long)j * n_lanes] = (uint8_t)(e >> 8);
  };

  int i = 0;
  for (; i + HUFF_ROUND <= max_rem; i += HUFF_ROUND) {
    if (i) {
      ring.fill<HUFF_ROUND / 4>(ring.word_of(wi) >> 2, buf, end);
      cp_async_commit();
      cp_async_wait<HUFF_PENDING>();
    }
#pragma unroll
    for (int j = 0; j < HUFF_ROUND; ++j) step(j);
    o += (long long)HUFF_ROUND * n_lanes;
  }
  for (; i < max_rem; ++i, o += n_lanes) step(0);
}

REPRO_API int repro_huffman_decode(const void* buf, long long n_bytes, const void* pos,
                                   const void* lut, int lut_log, void* out, int max_rem,
                                   long long n_lanes, void* stream) {
  if (lut_log < 3 || lut_log > 15 || max_rem < 1 || n_lanes < 1 || n_bytes < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_lanes + HUFF_LANES - 1) / HUFF_LANES;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // the limit for the largest LUT; a launch takes what its LUT needs
  cudaError_t err = cudaFuncSetAttribute(huffman_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         HUFF_RING_BYTES + (2 << 15));
  if (err != cudaSuccess) return (int)err;
  huffman_decode_kernel<<<(unsigned int)blocks, HUFF_LANES, HUFF_RING_BYTES + (2 << lut_log),
                          (cudaStream_t)stream>>>(
      (const uint8_t*)buf, n_bytes, (const long long*)pos, (const uint16_t*)lut, lut_log,
      (uint8_t*)out, max_rem, n_lanes);
  return (int)cudaGetLastError();
}
