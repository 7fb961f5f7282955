// K9 — tANS (FSE) encode: the backward state walk of every 1024-symbol lane.
//
// Replaces the TPU kernel src/repro/kernels/fse.py, fse_encode_pallas
// (_encode_kernel), which ran 256 lanes per grid step as vector lanes.
//
// Per lane of length r (the wire fixes 1024 symbols per lane): the state
// starts at st0[s] at position r-1; for every earlier position i it emits the
// low nb = nb0[s] - (X < thr[s]) bits of X = state + total and steps to
// enc[s][(X >> nb) - norm[s]] (kernels/ref.py fse_encode_lanes, which also
// clips that index as the reference does).  Outputs are the (value, nbits)
// planes in the (max_rem, n_lanes) layout and the final state of each lane;
// the suffix sums that place every emission in the concatenated wire
// layout, and the bit packer, stay PyTorch glue on the card (kernels/ref.py).
//
// Bound: the 9 bytes a symbol moves (1 read, two int32 written) for the
// main path's 65,536 lanes, and latency for a selector trial's 64: each lane
// is a chain of max_rem dependent steps.  Design:
//
// - Persistent blocks of FSE_LANES threads, one lane each, the grid sized to
//   the card's resident blocks, so a block builds its tables once and walks
//   lane groups in turn.
// - Nothing on a step's chain touches device memory.  The block's symbols
//   come into a shared ring of FSE_RING chunks of FSE_ROWS rows, consumed
//   from the last row backward, by 16-byte cp.async copies issued
//   FSE_RING - 1 chunks ahead.  A row's FSE_LANES symbols start anywhere
//   (row i is at lanesT + i*n_lanes), so the copy takes the aligned vectors
//   that hold them and the walk reads them at the row's byte offset.  A
//   lane reads its symbols two rows ahead and their packed values (FseSym,
//   built in the prologue) one row ahead.
// - The chain is as short as the tables the codec builds allow
//   (entropy._fse_tables_cached: nb0 = table_log + 1 - bit_length(norm),
//   thr = norm << nb0, st0[s] = enc[s][0], every state in [0, total)).  Then
//   X lies in [total, 2*total), X >> nb in [norm, 2*norm), and the
//   reference's clip never acts, so a step is nb -> X >> nb -> one table
//   load -> one select.  A symbol the table does not hold (norm 0) steps to
//   state 0 through its own entry, as the clip sends it there.  A lane's
//   first step is a table step too: until then the lane carries X = thr of
//   its next symbol, whose X >> nb is norm, the index of enc[s][0] = st0[s].
//   chip_smoke.py holds the kernel against the plain walk, absent symbols
//   included.
// - Up to FSE_SHARED_TABLE entries the table lives in shared memory as u16
//   entries that hold X = enc + total directly (below 2^16 while table_log
//   <= 15), plus one entry of X = total for the absent symbols, and nb is
//   (X + (nb0 << 16) - thr) >> 16 (|X - thr| < 2^16 there).  A larger table
//   stays in global memory, where the card's L2 (50 MB) holds it, as int32
//   entries, with nb0 - (X < thr) and a select for the absent symbols (the
//   kernel is templated on where the table lives).  X < 2^(table_log + 1)
//   is held in an int, so table_log is at most 30, the port's limit on both
//   sides (kernels/ref.py FSE_MAX_TABLE_LOG).
// - Each step stores its (value, nbits) straight into the (max_rem,
//   n_lanes) planes as streaming stores issued beside the chain: a warp's
//   32 lanes write 128 contiguous bytes of each.  Staging a chunk's rows in
//   shared memory and writing them out as 16-byte vectors measured slower
//   at both the 65,536-lane and the 64-lane shape: the write-out and its
//   barrier took the time the chain left idle.
#include "common.cuh"

#ifndef FSE_SHARED_TABLE  // the largest table held in shared memory, from the build
#error "fse.cu is built with -DFSE_SHARED_TABLE=<entries> (kernels/_build.py)"
#endif
static_assert(FSE_SHARED_TABLE <= (1 << 15), "u16 entries hold X = state + total < 2^16");
#define FSE_LANES 128               // lanes (threads) per block
#define FSE_ROWS 32                 // rows per staged chunk
#define FSE_RING 4                  // chunks in the symbol ring
#define FSE_ROW_BYTES (FSE_LANES + 16)  // a row's symbols with the aligned vector's head
#define FSE_ROW_VECS (FSE_ROW_BYTES / 16)

// One symbol's encode values.  thr; nbt, the nb term: (nb0 << 16) - thr for
// a shared table, nb0 for a global one; base, the table index of X >> nb = 0
// (sym_start - norm; for a symbol the table does not hold, total, the
// shared table's state-0 entry, or 0 for a global table); held, norm != 0.
struct __align__(16) FseSym {
  int thr, nbt, base, held;
};

struct FseShared {
  FseSym sym[256];
  uint8_t ring[FSE_RING][FSE_ROWS][FSE_ROW_BYTES];
  uint8_t spare[2][FSE_ROW_BYTES];  // read, and unused, by the last slot's look-ahead
  // then, for a shared table, total + 1 u16 entries: enc + total, then total
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy chunk c (rows hi..hi-FSE_ROWS+1, hi = max_rem-1 - c*FSE_ROWS) of the
// lanes lane0..lane0+nl-1 into ring slot `slot`: each row as the aligned
// 16-byte vectors that hold one of its bytes, so its lane t lands at
// byte (row address % 16) + t.  Every vector read holds a byte of lanesT.
__device__ __forceinline__ void fse_issue_chunk(FseShared& sh, int slot, const uint8_t* lanesT,
                                                long long n_lanes, long long lane0, int nl,
                                                int max_rem, int c) {
  const int hi = max_rem - 1 - c * FSE_ROWS;
  if (hi < 0) return;
  const int rows = hi + 1 < FSE_ROWS ? hi + 1 : FSE_ROWS;
  for (int idx = threadIdx.x; idx < rows * FSE_ROW_VECS; idx += FSE_LANES) {
    const int rr = idx / FSE_ROW_VECS, v = idx - rr * FSE_ROW_VECS;
    const uint8_t* row = lanesT + (long long)(hi - rr) * n_lanes + lane0;
    const uint8_t* vec = row - ((uintptr_t)row & 15) + 16 * v;
    if (vec < row + nl) cp_async16(&sh.ring[slot][rr][16 * v], vec);
  }
}

template <bool kSharedTable>
__global__ void __launch_bounds__(FSE_LANES)
fse_encode_kernel(const uint8_t* __restrict__ lanesT, const int* __restrict__ rem,
                  const int* __restrict__ nb0, const int* __restrict__ thr,
                  const int* __restrict__ norm, const int* __restrict__ sym_start,
                  const int* __restrict__ enc, int* __restrict__ vals, int* __restrict__ nbs,
                  int* __restrict__ state_out, int max_rem, long long n_lanes, int total,
                  long long n_groups) {
  extern __shared__ __align__(16) uint8_t smem[];
  FseShared& sh = *reinterpret_cast<FseShared*>(smem);
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem + sizeof(FseShared));
  const int t = threadIdx.x;
  for (int s = t; s < 256; s += FSE_LANES) {
    const int n = norm[s];
    sh.sym[s] = kSharedTable
                    ? FseSym{thr[s], (nb0[s] << 16) - thr[s], n ? sym_start[s] - n : total, n != 0}
                    : FseSym{thr[s], nb0[s], n ? sym_start[s] - n : 0, n != 0};
  }
  if (kSharedTable) {
    for (int i = t; i < total; i += FSE_LANES) s_tab[i] = (uint16_t)(enc[i] + total);
    if (t == 0) s_tab[total] = (uint16_t)total;  // state 0, for the absent symbols
  }

  const int n_chunks = (max_rem + FSE_ROWS - 1) / FSE_ROWS;
  for (long long g = blockIdx.x; g < n_groups; g += gridDim.x) {
    // the tables are built, and every thread is done with the last group's
    // ring slots
    __syncthreads();
    const long long lane0 = g * FSE_LANES;
    const int nl = (int)(n_lanes - lane0 < FSE_LANES ? n_lanes - lane0 : FSE_LANES);
    const bool live = t < nl;
    const int r = live ? rem[lane0 + t] : 0;
    int X = total;
    // row max_rem-1's byte offset in its 16-byte vector; it steps back by
    // n_lanes a row
    int sym_off = (int)((uintptr_t)(lanesT + (long long)(max_rem - 1) * n_lanes + lane0) & 15);
    const int sym_step = (int)(n_lanes & 15);
#pragma unroll
    for (int c = 0; c < FSE_RING - 1; ++c) {
      fse_issue_chunk(sh, c, lanesT, n_lanes, lane0, nl, max_rem, c);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<FSE_RING - 2>();
      // chunk c has landed, and every thread is done with chunk c - 1, whose
      // slot takes chunk c + FSE_RING - 1
      __syncthreads();
      fse_issue_chunk(sh, (c + FSE_RING - 1) % FSE_RING, lanesT, n_lanes, lane0, nl, max_rem,
                      c + FSE_RING - 1);
      cp_async_commit();
      const int hi = max_rem - 1 - c * FSE_ROWS;
      const int rows = hi + 1 < FSE_ROWS ? hi + 1 : FSE_ROWS;
      if (!live) {
        sym_off = (sym_off - rows * sym_step) & 15;
        continue;
      }
      const uint8_t(*ring)[FSE_ROW_BYTES] = sh.ring[c % FSE_RING];
      // symbols two rows ahead, values one row ahead (the rows past the
      // chunk read stale bytes, which only index sh.sym; their values are
      // used only by a lane that has not started, and are replaced here)
      int s_next = ring[1][((sym_off - sym_step) & 15) + t];
      FseSym e = sh.sym[ring[0][sym_off + t]];
      if (r - 1 <= hi) X = e.thr;  // the lane starts at or below row hi
#pragma unroll 2
      for (int rr = 0; rr < rows; ++rr) {
        const int i = hi - rr;
        const int s_after = ring[rr + 2][((sym_off - 2 * sym_step) & 15) + t];
        const FseSym e_next = sh.sym[s_next];
        int nb, stepped;
        if constexpr (kSharedTable) {
          nb = (X + e.nbt) >> 16;
          stepped = s_tab[e.base + (X >> nb)];
        } else {
          nb = e.nbt - (X < e.thr ? 1 : 0);
          const int k = e.base + (X >> nb);
          stepped = e.held ? __ldg(enc + k) + total : total;
        }
        const int nbe = r > i + 1 ? nb : 0;  // emits at every position before its start
        // the offset from i each step: a running 64-bit offset, carried from
        // step to step, made the 64-lane walk a third slower
        const long long at = (long long)i * n_lanes + lane0 + t;
        __stcs(vals + at, (int)((unsigned)X & ((1u << nbe) - 1u)));
        __stcs(nbs + at, nbe);
        X = r > i ? stepped : e_next.thr;  // the first step, or the next one's X
        s_next = s_after;
        e = e_next;
        sym_off = (sym_off - sym_step) & 15;
      }
    }
    if (live) state_out[lane0 + t] = r > 0 ? X - total : 0;
  }
}

// The grid: the card's resident blocks at this table's shared memory, found
// once per device and table_log (the queries cost host time that a 64-lane
// launch would wait for).  The kernel's shared-memory limit only grows, so a
// smaller table never lowers it under a larger one found before.
template <bool kSharedTable>
static int encode_grid(int total, size_t smem, long long* blocks_out) {
  static int resident[16][31];  // [device][table_log]: blocks, 0 until found
  static size_t smem_set[16];   // [device]: the limit set so far
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int table_log = 0;
  while ((1 << table_log) < total) ++table_log;
  if (device >= 16 || table_log > 30 || (1 << table_log) != total)
    return (int)cudaErrorInvalidValue;
  auto kernel = fse_encode_kernel<kSharedTable>;
  if (smem > smem_set[device]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    smem_set[device] = smem;
  }
  int& blocks = resident[device][table_log];
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FSE_LANES,
                                                             smem)) != cudaSuccess)
      return (int)err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks_out = blocks;
  return (int)cudaSuccess;
}

template <bool kSharedTable>
static int launch_encode(const void* lanesT, const void* rem, const void* nb0,
                         const void* thr, const void* norm, const void* sym_start,
                         const void* enc, void* vals, void* nbs, void* state, int max_rem,
                         long long n_lanes, int total, cudaStream_t stream) {
  const size_t smem =
      sizeof(FseShared) + (kSharedTable ? (size_t)(total + 1) * sizeof(uint16_t) : 0);
  long long resident = 0;
  const int err = encode_grid<kSharedTable>(total, smem, &resident);
  if (err != (int)cudaSuccess) return err;
  const long long groups = (n_lanes + FSE_LANES - 1) / FSE_LANES;
  fse_encode_kernel<kSharedTable><<<repro_grid(groups, 1, resident), FSE_LANES, smem, stream>>>(
      (const uint8_t*)lanesT, (const int*)rem, (const int*)nb0, (const int*)thr,
      (const int*)norm, (const int*)sym_start, (const int*)enc, (int*)vals, (int*)nbs,
      (int*)state, max_rem, n_lanes, total, groups);
  return (int)cudaGetLastError();
}

// The tables are the codec's (see the design notes above): st0 and width
// are fixed by them (st0[s] = enc[s][0], width = the largest norm), so the
// kernel reads neither.
REPRO_API int repro_fse_encode(const void* lanesT, const void* rem, const void* nb0,
                               const void* thr, const void* st0, const void* norm,
                               const void* sym_start, const void* enc, void* vals,
                               void* nbs, void* state, int max_rem, long long n_lanes,
                               int total, int width, void* stream) {
  (void)st0;
  (void)width;
  if (n_lanes < 1 || max_rem < 0) return (int)cudaErrorInvalidValue;
  if (total <= FSE_SHARED_TABLE)
    return launch_encode<true>(lanesT, rem, nb0, thr, norm, sym_start, enc, vals, nbs, state,
                               max_rem, n_lanes, total, (cudaStream_t)stream);
  return launch_encode<false>(lanesT, rem, nb0, thr, norm, sym_start, enc, vals, nbs, state,
                              max_rem, n_lanes, total, (cudaStream_t)stream);
}

// K10 — tANS (FSE) decode: the forward state walk of every 1024-symbol lane,
// reading the lane's bits backward from its end.
//
// Replaces the TPU kernel src/repro/kernels/fse.py, fse_decode_pallas
// (_decode_kernel), which ran 256 lanes per grid step over per-lane padded
// buffers built on the host, with int32 cursors.
//
// Per step a lane emits dec_sym[state], moves its cursor back by
// nb = dec_nb[state] bits, takes the 32-bit window there (refill32, the K16
// body in common.cuh) and steps to dec_base[state] + (window & (2^nb - 1)).
// A cursor that falls below the lane's start reads the lane's first byte at
// bit (cursor & 7), as the reference clamps it (max(cursor >> 3, 0)); only
// the step after a lane's last symbol does that, and its state is unused.
//
// Bound: latency.  Each lane is a chain of 1024 dependent table steps.
// Design: one thread per lane.  The decode tables come as two arrays of
// 2^table_log entries: the symbols (u8) and nb | dec_base << 5 (u32 up to
// table_log 26; from table_log 27, where dec_base needs more than 27 bits,
// u64, so the tables of those frames take 9 bytes a state: 1.125 GiB at
// table_log 27).  Up to FSE_SHARED_TABLE entries the
// block merges them into one u32 per state in dynamic shared memory
// (sym | (nb | dec_base << 5) << 8, which fits up to table_log 19),
// so a step is one shared-memory load (8 KiB at table_log 11, 128 KiB at
// table_log 15; above 48 KB the launch sets the attribute).  A larger table
// is read from global memory, two loads per step, where the L2 holds it
// (the kernel is templated on where the tables live and on the step entry's
// width).  Lanes read the concatenated wire bitstream at
// their own byte offsets (lane_base, the exclusive sum of (bitlen + 7) / 8):
// every unmasked bit a step uses lies inside its own lane, and the caller
// pads the tail by 8 bytes.  The output is the (max_rem, n_lanes) plane
// layout, coalesced per step; K4 puts it back into symbol order.
template <bool kSharedTable, typename Entry>
__global__ void fse_decode_kernel(const uint8_t* __restrict__ buf,
                                  const long long* __restrict__ lane_base,
                                  const long long* __restrict__ bitlen,
                                  const int* __restrict__ state0,
                                  const uint8_t* __restrict__ sym,
                                  const Entry* __restrict__ nbb,
                                  uint8_t* __restrict__ out, int max_rem,
                                  long long n_lanes, int total) {
  extern __shared__ uint32_t s_tab[];
  if (kSharedTable) {
    for (int i = threadIdx.x; i < total; i += blockDim.x)
      s_tab[i] = (uint32_t)sym[i] | ((uint32_t)nbb[i] << 8);
    __syncthreads();
  }
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const uint8_t* lb = buf + lane_base[lane];
  long long cursor = bitlen[lane];
  uint32_t state = (uint32_t)state0[lane];
  uint8_t* o = out + lane;
  for (int i = 0; i < max_rem; ++i) {
    Entry e;
    if (kSharedTable) {
      const uint32_t packed = s_tab[state];
      o[(long long)i * n_lanes] = (uint8_t)packed;
      e = packed >> 8;
    } else {
      e = nbb[state];
      o[(long long)i * n_lanes] = sym[state];
    }
    const uint32_t nb = (uint32_t)e & 0x1Fu;
    cursor -= nb;
    const uint32_t win = refill32(lb, cursor >= 0 ? cursor : (cursor & 7));
    state = (uint32_t)(e >> 5) + (win & ((1u << nb) - 1u));
  }
}

template <bool kSharedTable, typename Entry>
static int launch_decode(const void* buf, const void* lane_base, const void* bitlen,
                         const void* state0, const void* sym, const void* nbb, void* out,
                         int max_rem, long long n_lanes, int total, cudaStream_t stream) {
  const int threads = 128;
  const size_t smem = kSharedTable ? (size_t)total * sizeof(uint32_t) : 0;
  cudaError_t err = cudaFuncSetAttribute(fse_decode_kernel<kSharedTable, Entry>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_lanes + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fse_decode_kernel<kSharedTable, Entry><<<(unsigned int)blocks, threads, smem, stream>>>(
      (const uint8_t*)buf, (const long long*)lane_base, (const long long*)bitlen,
      (const int*)state0, (const uint8_t*)sym, (const Entry*)nbb, (uint8_t*)out,
      max_rem, n_lanes, total);
  return (int)cudaGetLastError();
}

// entry_bytes is 4 (nb | dec_base << 5 in a u32, table_log <= 26) or 8 (u64)
REPRO_API int repro_fse_decode(const void* buf, const void* lane_base, const void* bitlen,
                               const void* state0, const void* sym, const void* nbb,
                               void* out, int max_rem, long long n_lanes, int total,
                               int entry_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (entry_bytes == 8)
    return launch_decode<false, unsigned long long>(buf, lane_base, bitlen, state0, sym,
                                                    nbb, out, max_rem, n_lanes, total, s);
  if (entry_bytes != 4) return (int)cudaErrorInvalidValue;
  if (total <= FSE_SHARED_TABLE)
    return launch_decode<true, uint32_t>(buf, lane_base, bitlen, state0, sym, nbb, out,
                                         max_rem, n_lanes, total, s);
  return launch_decode<false, uint32_t>(buf, lane_base, bitlen, state0, sym, nbb, out,
                                        max_rem, n_lanes, total, s);
}
