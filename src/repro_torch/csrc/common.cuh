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

// cp.async: 16 bytes from global to shared memory, bypassing L1, in groups
// that a thread commits and waits for (K9's symbol ring, and the K15 and K10
// lane rings below).  `src_bytes` 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           unsigned src_bytes = 16) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One entropy lane's bytes, fetched ahead of its decode into a ring of RING
// 16-byte slots in shared memory (K15 reads its lane forward, K10 backward).
// The decoders take their bits from it, not from a window gathered at the
// cursor in device memory (K16's refill32, which runs only in its own launch
// in csrc/lane_refill.cu).
//
// Vector v of the lane is the aligned 16 bytes at v0 + 16v (forward) or
// v0 - 16v (backward); word d is its word d & 3 (forward) or 3 - (d & 3)
// (backward), so the words run in the lane's reading order.  Vector v lands
// in slot v + rot mod RING (backward: the slots in reverse), so word d sits
// at ring word d + 4 rot mod 4*RING (backward: ~d + 4 rot).  `rot`, the
// thread's index mod 8, spreads lanes that read the same word of their rings
// (a warp decoding a run of one symbol does) over the eight 16-byte bank
// groups of shared memory: a 4-way bank conflict at worst instead of 32.
//
// The copies are cp.async issued by the lane's own thread: `fill<N>(keep)`
// issues up to N more vectors, none past vector keep + RING - 1, so the slot
// of vector keep - 1 and older ones are reused.  A vector that holds no byte
// of [lo, hi), the bitstream's allocation, is written as zeros and never
// read: the read-ahead stays inside the allocation whatever the caller
// padded, and every bit the decode uses is a bit of the allocation.  The
// caller commits and waits on a schedule that is the same for every lane of
// a warp (a warp's loads share one scoreboard, so a lane that waited on its
// own recent copy would stall the warp for every other lane's).  Word
// indices are 32-bit: a lane reads less than 16 GiB.
template <int RING, bool kForward>
struct LaneRing {
  uint32_t* words;        // this thread's 4 * RING words
  const uint8_t* v0;      // the lane's vector 0, 16-byte aligned
  unsigned rot;           // the slots' rotation, threadIdx.x mod 8
  unsigned filled;        // vectors issued so far

  template <int N>
  __device__ __forceinline__ void fill(unsigned keep, const uint8_t* lo, const uint8_t* hi) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (filled < keep + RING) {
        const uint8_t* a = kForward ? v0 + 16ll * filled : v0 - 16ll * filled;
        const bool held = a + 16 > lo && a < hi;
        cp_async16(words + 4 * (((kForward ? filled : ~filled) + rot) & (RING - 1)),
                   held ? a : lo, held ? 16u : 0u);
        ++filled;
      }
    }
  }

  // A word's ring index: d (backward: ~d) + 4 rot, so the next word's is
  // one more (backward: one less); `word` reads it, `word_of` inverts it.
  __device__ __forceinline__ unsigned index(unsigned d) const {
    return (kForward ? d : ~d) + 4 * rot;
  }
  __device__ __forceinline__ unsigned word_of(unsigned i) const {
    return kForward ? i - 4 * rot : ~(i - 4 * rot);
  }
  __device__ __forceinline__ uint32_t word(unsigned i) const {
    return words[i & (4 * RING - 1)];
  }
};

__device__ __forceinline__ void words_of(const uint4& v, uint32_t* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// The staged slot of a warp's 16-byte chunk c, where a warp passes its
// chunks through shared memory so that each global access instruction
// covers 512 contiguous bytes: the low three bits XORed with the next three,
// so that a quarter-warp's 16-byte accesses hit eight distinct bank groups
// both when lane l writes chunks l*W..l*W+W-1 (W = 1, 2, 4 or 8) and when it
// reads chunks l, l + 32, ...  K4's narrow path, K6 and K2 stage this way.
__device__ __forceinline__ int stage_slot(int c) { return c ^ ((c >> 3) & 7); }

// N words of a byte stream at byte offset s (0-15) into its words b[0..N+3]:
// o[k] holds bytes 4k+s..4k+s+3.  The word select avoids indexing a register
// array (which would put b in local memory), and funnel shifts join each
// pair of neighbours.  K4's load16 and load_run below share it.
template <int N>
__device__ __forceinline__ void join_at(const uint32_t* b, unsigned s, uint32_t* o) {
  const unsigned q = s >> 2, shift = 8 * (s & 3);
  uint32_t u[N + 1];  // b[q..q+N]
#pragma unroll
  for (int i = 0; i <= N; ++i)
    u[i] = q == 0 ? b[i] : q == 1 ? b[i + 1] : q == 2 ? b[i + 2] : b[i + 3];
#pragma unroll
  for (int k = 0; k < N; ++k) o[k] = __funnelshift_r(u[k], u[k + 1], shift);
}

// A run of 16*V bytes at p, as 4*V words, read as streaming 16-byte vectors
// (ld.global.cs: each byte is read once).  The caller's warp reads
// consecutive runs (lane l's p is lane 0's plus 16*V*l), so p's offset
// s = p % 16 is the same in every lane, and the host chooses SHIFTED from
// the array's pointer (s != 0).  `full`: the run lies wholly before `end`,
// the array's end; o is written only for such a lane, and the caller reads
// a partial run element by element.
//
// Aligned, a lane loads its V vectors.  Shifted, a run spans the V + 1
// aligned vectors from p - s: a lane loads the first V and takes the last
// from the next lane, whose first vector it is (lane 31 loads it itself),
// so each vector is read once per warp; the words are then joined at the
// byte offset (join_at).  Every vector read holds at least one byte
// of the array (a lane loads its first vector wherever it starts before
// `end`), so none leaves the allocation: device memory is mapped in
// granules far larger than 16 bytes.  Every lane of the warp must call it.
template <int V, bool SHIFTED>
__device__ __forceinline__ void load_run(const uint8_t* p, const uint8_t* end, bool full,
                                         uint32_t* o) {
  if constexpr (!SHIFTED) {
    if (full) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        words_of(__ldcs(reinterpret_cast<const uint4*>(p) + v), o + 4 * v);
    }
  } else {
    const unsigned s = (unsigned)((uintptr_t)p & 15);
    const uint4* a = reinterpret_cast<const uint4*>(p - s);
    uint32_t b[4 * V + 4] = {};
    if (reinterpret_cast<const uint8_t*>(a) < end) words_of(__ldcs(a), b);
    if (full) {
#pragma unroll
      for (int v = 1; v < V; ++v) words_of(__ldcs(a + v), b + 4 * v);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) b[4 * V + k] = __shfl_down_sync(0xffffffffu, b[k], 1);
    if ((threadIdx.x & 31) == 31 && full) words_of(__ldcs(a + V), b + 4 * V);
    join_at<4 * V>(b, s, o);
  }
}

// Exclusive prefix of v over the block (blockDim a multiple of 32, at most
// 1024); *total receives the block's sum.  Every thread must call it.  The
// single-pass scan of K2 (delta.cu) scans its thread totals with it.
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
