// The single-pass prefix scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// NVR-2016-002) that K2 (delta.cu) and K12 (fused_delta_bitpack.cu) share.
//
// A call's scratch holds a ticket counter (SCAN_COUNTER_BYTES) followed by
// one status per tile; the call zeroes it with a memset on its stream before
// the launch, so no call reads another's.  Blocks start in no order, and a
// block that waits on a tile no block holds yet would wait forever.  So a
// block takes its tile index from the ticket (take_tile), not from
// blockIdx: when it waits on tile j < i, tile j's block is already running
// and itself waits only on tiles below j.  Warp 0 of the block then
// publishes the tile's aggregate, finds the sum of all earlier tiles by
// looking back over its predecessors' statuses 32 at a time, and publishes
// the tile's inclusive prefix (tiles_before).
#pragma once

#include "common.cuh"

#define SCAN_COUNTER_BYTES 16  // the ticket counter, ahead of the statuses

enum : unsigned { TILE_INVALID = 0, TILE_AGGREGATE = 1, TILE_PREFIX = 2 };

// A tile's status: K = sizeof(A) / 4 64-bit words (one for 32-bit sums, two
// for 64-bit ones), word k holding the flag in its high half and bits
// 32k..32k+31 of the value in its low half.  Each word is written at most
// twice per call (the aggregate, then the prefix), after the memset's zero.
// An aligned 64-bit access is single-copy atomic, so a word read shows the
// zero (TILE_INVALID) or a whole (flag, piece) pair; the two words of a
// 64-bit status may be read torn, which shows as unequal flags, and the
// reader polls again.  A reader uses only what the status words carry, so
// the stores and loads need no ordering against other memory: volatile
// (relaxed) accesses suffice, where release stores and acquire loads, which
// also order the rest of memory, made K2 slower on an H100.
template <typename A>
struct Status {
  static constexpr int K = (int)sizeof(A) / 4;
  unsigned long long* word;
  __device__ explicit Status(unsigned char* scratch)
      : word(reinterpret_cast<unsigned long long*>(scratch + SCAN_COUNTER_BYTES)) {}
  __device__ void publish(long long tile, unsigned flag, A value) const {
    const unsigned long long f = (unsigned long long)flag << 32;
    const unsigned long long lo = f | (uint32_t)value;
    const unsigned long long hi = f | (uint32_t)((unsigned long long)value >> 32);
    unsigned long long* p = word + K * tile;
    if constexpr (K == 1)
      asm volatile("st.volatile.global.u64 [%0], %1;" ::"l"(p), "l"(lo) : "memory");
    else
      asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(lo), "l"(hi)
                   : "memory");
  }
  __device__ unsigned poll(long long tile, A* value) const {
    const unsigned long long* p = word + K * tile;
    unsigned long long lo, hi = 0;
    if constexpr (K == 1)
      asm volatile("ld.volatile.global.u64 %0, [%1];" : "=l"(lo) : "l"(p) : "memory");
    else
      asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(lo), "=l"(hi) : "l"(p)
                   : "memory");
    const unsigned flag = (unsigned)(lo >> 32);
    if constexpr (K == 2) {
      if ((unsigned)(hi >> 32) != flag) return TILE_INVALID;  // torn: poll again
      *value = (uint32_t)lo | ((A)(uint32_t)hi << 32);
    } else {
      *value = (uint32_t)lo;
    }
    return flag;
  }
};

// The scratch bytes of a call over `tiles` tiles with sums of type A: the
// counter, then the statuses, all zeroed by the call.
template <typename A>
static long long scan_scratch_bytes(long long tiles) {
  return SCAN_COUNTER_BYTES + (long long)sizeof(unsigned long long) * Status<A>::K * tiles;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's tile: the next ticket of the call's counter.  Every thread
// must call it, once per block.
__device__ __forceinline__ long long take_tile(unsigned char* scratch) {
  __shared__ unsigned int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  return ticket;
}

// Run by warp 0 of the block that holds `tile`, whose sum is `total`:
// publishes the tile's aggregate, returns (in every lane) the sum of all
// earlier tiles, and publishes the tile's inclusive prefix.  Lane l inspects
// predecessor `end - l`; the warp waits until every predecessor nearer than
// the nearest inclusive prefix in the window has at least its aggregate,
// then adds those aggregates and that prefix, or, with no prefix in the
// window, all 32 aggregates, and moves the window back by 32.
template <typename A>
__device__ __forceinline__ A look_back(const Status<A>& st, long long tile, A total) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) st.publish(0, TILE_PREFIX, total);
    return 0;
  }
  if (lane == 0) st.publish(tile, TILE_AGGREGATE, total);
  A before = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long p = end - lane;
    A value = 0;
    unsigned flag = p >= 0 ? TILE_INVALID : TILE_PREFIX;  // before tile 0: a prefix of 0
    unsigned prefix, nearer;
    for (;;) {
      if (flag == TILE_INVALID) flag = st.poll(p, &value);
      prefix = __ballot_sync(0xffffffffu, flag == TILE_PREFIX);
      nearer = prefix ? (prefix & (0u - prefix)) - 1 : 0xffffffffu;
      if (!(__ballot_sync(0xffffffffu, flag == TILE_INVALID) & nearer)) break;
    }
    const unsigned used = prefix ? nearer | (prefix & (0u - prefix)) : 0xffffffffu;
    before += warp_sum<A>((used >> lane) & 1 ? value : (A)0);
    if (prefix) break;
  }
  if (lane == 0) st.publish(tile, TILE_PREFIX, before + total);
  return before;
}

// The sum of all tiles before `tile`, in every thread of its block, whose
// sum is `tile_total` (warp 0 looks back).  Every thread must call it.
template <typename A>
__device__ __forceinline__ A tiles_before(unsigned char* scratch, long long tile, A tile_total) {
  __shared__ A before;
  if (threadIdx.x < 32) {
    const A b = look_back<A>(Status<A>(scratch), tile, tile_total);
    if (threadIdx.x == 0) before = b;
  }
  __syncthreads();
  return before;
}
