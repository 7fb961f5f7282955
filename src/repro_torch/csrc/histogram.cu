// K13 — histogram: the 256-bin count of a byte stream, exact at any size.
//
// Replaces the TPU kernel src/repro/kernels/histogram.py, histogram_pallas
// (_hist_kernel), which built the one-hot matrix of each 4096-byte block and
// contracted it with a ones vector on the MXU in float32 — exact only below
// 2^24 counts per bin, which is why the reference's entropy coders took the
// XLA scatter-add histogram_exact instead.  Here the counts are integers
// throughout (u32 per counter and per block, u64 in the output), so the
// kernel computes the exact histogram that Huffman and tANS table
// construction need, at any size.
//
// Bound: bytes.  The function reads n bytes once and writes 256 counts.
//
// Design.  Skewed input — the high byte planes of a column, the exponent
// plane of weights — puts most bytes in one or two bins, and atomics that
// the lanes of a warp share on one address serialise.  So no two lanes of a
// warp share a counter: the counters are u32 words in regions of 64 KiB,
// word (b, h, l) of a region at byte offset 256 b + 128 h + 4 l for bin b,
// lane l and h the warp's parity, so lane l's counters all lie in bank l
// and an increment never meets another lane of its warp in a bank, whatever
// the bins.  Warp w counts into region (w / 2) mod R with h = w mod 2; the
// warps that share a region's half (HConfig::SHARE) meet only across
// instructions.  A thread holds its counters' offset with byte 1 clear, so
// one byte permute (prmt) puts a byte of its input into byte 1 and gives
// the counter's offset, and red.shared.add.u32 (an atomicAdd whose result
// is unused) adds 1: two instructions a byte, and no load of a counter
// precedes the next byte's add, so no byte waits on the one before.
// Skewed and uniform input cost the same.
//
// A thread loads H_VEC streaming 16-byte chunks a tile (each warp 512
// contiguous bytes a load), blocks take tiles in a grid-stride loop, and a
// thread issues the next tile's loads before it counts the current one (the
// first tile's before it clears the counters).  Two configurations: a
// stream of up to SMALL_TILES of its tiles (a selector trial's 64 KiB
// sample) takes one block of Small (one region, so its clearing and its
// reduction are short), which writes the 256 counts itself, so the call is
// one launch; a larger one takes blocks of Large (two regions and 16
// warps, one block an SM: on an H100 the fastest of the shapes timed, one
// to three regions of 6 to 32 warps), a block for every H_MIN_TILES tiles,
// at most the blocks that fit on the card at once, which add their counts
// to the output with one global atomic per non-zero bin after the call
// zeroes it with a memset.  The grid also keeps each block under 2^32
// bytes, so no counter, a lane's or a block's sum, can wrap.  The counters
// are cleared with 16-byte stores; at the end thread t sums bin t over the
// 64 words of its row in each region, word (j + t) mod 64 at step j, so
// the 32 threads of a warp read 32 banks: no conflict.  The bytes before
// the first 16-byte boundary and after the last one (fewer than 32) go
// one per lane through warp 0 of block 0.
#include "common.cuh"

#define H_VEC 8          // 16-byte chunks a thread loads a tile
#define H_MIN_TILES 4    // tiles a Large block takes at least, where it can
#define H_REGION 65536   // bytes of one counter region

template <int R, int WARPS>
struct HConfig {
  static constexpr int REGIONS = R;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int SMEM = R * H_REGION;
  static constexpr int SHARE = WARPS / (2 * R);  // warps that count into one half-region
  static constexpr long long TILE_CHUNKS = (long long)THREADS * H_VEC;
  // tiles a block may take and still count under 2^32 bytes, the head and
  // tail's 31 included
  static constexpr long long BLOCK_TILES = ((1LL << 32) - 32) / (16 * TILE_CHUNKS);
  static_assert(SHARE >= 1 && SHARE * 2 * R == WARPS && THREADS <= 1024,
                "every warp counts into a half-region, and as many into each");
};
typedef HConfig<1, 8> Small;
typedef HConfig<2, 16> Large;
#define SMALL_TILES 2  // Small's tiles of 32 KiB: a selector trial's 64 KiB sample

// Adds the four bytes of w to the thread's counters, whose offsets are
// `own` with byte 1 replaced by the byte.
__device__ __forceinline__ void count_word(unsigned char* hist, uint32_t own, uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    atomicAdd(reinterpret_cast<uint32_t*>(hist + __byte_perm(w, own, 0x7604u | (k << 4))), 1u);
}

__device__ __forceinline__ void count_chunk(unsigned char* hist, uint32_t own, const uint4& q) {
  count_word(hist, own, q.x);
  count_word(hist, own, q.y);
  count_word(hist, own, q.z);
  count_word(hist, own, q.w);
}

template <typename C>
__global__ void __launch_bounds__(C::THREADS, 1)
histogram_kernel(const uint8_t* __restrict__ x, long long head, long long n_chunks,
                 long long n, unsigned long long* __restrict__ out) {
  extern __shared__ uint4 hist4[];
  const uint4* body = reinterpret_cast<const uint4*>(x + head);
  const long long full_tiles = n_chunks / C::TILE_CHUNKS;
  long long t = blockIdx.x;
  uint4 cur[H_VEC];
  if (t < full_tiles) {  // the first tile's loads fly while the counters clear
#pragma unroll
    for (int k = 0; k < H_VEC; ++k)
      cur[k] = __ldcs(body + t * C::TILE_CHUNKS + k * C::THREADS + threadIdx.x);
  }
  for (int i = threadIdx.x; i < C::SMEM / 16; i += C::THREADS) hist4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  unsigned char* hist = reinterpret_cast<unsigned char*>(hist4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t own = ((warp >> 1) % C::REGIONS) * H_REGION + (warp & 1) * 128 + 4 * lane;
  for (; t < full_tiles; t += gridDim.x) {
    uint4 next[H_VEC];
    const long long u = t + gridDim.x;
    if (u < full_tiles) {
#pragma unroll
      for (int k = 0; k < H_VEC; ++k)
        next[k] = __ldcs(body + u * C::TILE_CHUNKS + k * C::THREADS + threadIdx.x);
    }
#pragma unroll
    for (int k = 0; k < H_VEC; ++k) count_chunk(hist, own, cur[k]);
#pragma unroll
    for (int k = 0; k < H_VEC; ++k) cur[k] = next[k];
  }
  if (t == full_tiles) {  // the partial tile, if any: this block's next in its stride
#pragma unroll
    for (int k = 0; k < H_VEC; ++k) {
      const long long c = t * C::TILE_CHUNKS + k * C::THREADS + threadIdx.x;
      if (c < n_chunks) count_chunk(hist, own, __ldcs(body + c));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // the unaligned head [0, head) and the tail [head + 16 n_chunks, n)
    const long long i = lane < head ? lane : head + 16 * n_chunks + (lane - head);
    if (lane < head || i < n)
      atomicAdd(reinterpret_cast<uint32_t*>(hist + (own | (uint32_t)x[i] << 8)), 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += C::THREADS) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(hist + 256 * b);
    uint32_t sum = 0;
#pragma unroll
    for (int r = 0; r < C::REGIONS; ++r) {
#pragma unroll 8
      for (int j = 0; j < 64; ++j) sum += row[r * (H_REGION / 4) + ((j + b) & 63)];
    }
    if (gridDim.x == 1)
      out[b] = sum;
    else if (sum)
      atomicAdd(out + b, (unsigned long long)sum);
  }
}

// The blocks of Large that fit on the card at once (one an SM), found once
// a device; the dynamic shared-memory limits of both are set then.
static int resident_blocks(long long* blocks) {
  static int resident[16];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 16) return (int)cudaErrorInvalidValue;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(histogram_kernel<Small>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, Small::SMEM)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(histogram_kernel<Large>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, Large::SMEM)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel<Large>,
                                                             Large::THREADS, Large::SMEM)) !=
            cudaSuccess)
      return (int)err;
    resident[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = resident[device];
  return (int)cudaSuccess;
}

// x: n >= 1 bytes at any address -> out: 256 u64 counts, written whole.
REPRO_API int repro_histogram(const void* x, long long n, void* out, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* p = (const uint8_t*)x;
  long long head = (long long)((16 - ((uintptr_t)p & 15)) & 15);
  if (head > n) head = n;
  const long long n_chunks = (n - head) / 16;
  long long resident = 0;
  const int rc = resident_blocks(&resident);
  if (rc != (int)cudaSuccess) return rc;
  unsigned long long* o = (unsigned long long*)out;
  if (n_chunks <= SMALL_TILES * Small::TILE_CHUNKS) {
    histogram_kernel<Small><<<1, Small::THREADS, Small::SMEM, s>>>(p, head, n_chunks, n, o);
    return (int)cudaGetLastError();
  }
  // a block for every H_MIN_TILES tiles, at most `resident`, at least as many
  // as keep each block's tiles under 2^32 bytes
  const long long tiles = (n_chunks + Large::TILE_CHUNKS - 1) / Large::TILE_CHUNKS;
  long long blocks = (tiles + H_MIN_TILES - 1) / H_MIN_TILES;
  if (blocks > resident) blocks = resident;
  if (blocks < (tiles + Large::BLOCK_TILES - 1) / Large::BLOCK_TILES)
    blocks = (tiles + Large::BLOCK_TILES - 1) / Large::BLOCK_TILES;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (blocks > 1) {
    const cudaError_t err = cudaMemsetAsync(out, 0, 256 * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
  }
  histogram_kernel<Large><<<(unsigned int)blocks, Large::THREADS, Large::SMEM, s>>>(
      p, head, n_chunks, n, o);
  return (int)cudaGetLastError();
}
