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
// (K9's u16 entries hold X = state + total < 2^16; K10's u32 entries hold
// 4 * dec_base above bit 13)
static_assert(FSE_SHARED_TABLE <= (1 << 15), "a shared table has at most 2^15 entries");
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

// K10 — tANS (FSE) decode: the forward state walk of every lane (1024
// symbols on the wire), reading the lane's bits backward from its end.
//
// Replaces the TPU kernel src/repro/kernels/fse.py, fse_decode_pallas
// (_decode_kernel), which ran 256 lanes per grid step over per-lane padded
// buffers built on the host, with int32 cursors.
//
// Per step (kernels/ref.py fse_decode_lanes) a lane emits dec_sym[state],
// moves its cursor back by nb = dec_nb[state] bits and steps to
// dec_base[state] + the nb bits at the cursor (LSB-first).  A cursor that
// falls below the lane's start reads the lane's first byte at bit
// (cursor & 7), as the reference clamps it (max(cursor >> 3, 0)); a full lane
// does that only on the step after its last symbol, whose state is unused,
// a short lane on every surplus row.
//
// Bound: the 65,536-lane main path reads ~31 MB and writes 64 MiB, but each
// lane is a chain of 1024 dependent steps, so the walk's instructions and
// their latency set the time.  Design: nothing on a lane's chain reads
// device memory, unless the table itself lives there.
// - Bits fetched ahead, as K15 does (huffman.cu): each lane's bytes come,
//   from its end down, into its LaneRing (common.cuh) of FSE_DEC_RING
//   16-byte slots by cp.async, topped up every FSE_DEC_ROUND steps.  A copy
//   of a vector that holds no byte of `buf` writes zeros and reads nothing,
//   so the read-ahead is clamped to the allocation and the glue's padding
//   (8 zero bytes, entropy.fse_lanes) is unchanged; the clamped reads below
//   the lane's start use its first five bytes, read once.
// - A 64-bit container D holds the bits below the cursor left-aligned (bit
//   63 is the bit just below it), at least 32 at a step's start; the nb bits
//   a step takes are D's top nb bits.  When fewer than 32 remain, the ring's
//   next word (read a step before) goes in under them, without a branch.
// - The clamp is off the chain: a warp tracks its cursors and selects the
//   clamped read only in a round where one of its lanes is within 32 bits a
//   step of its start (found from the ring position once a round).
// - Up to FSE_SHARED_TABLE entries the block packs each state's entry into
//   one u32 in shared memory: 31 - nb in bits 0-4, the symbol in bits 5-12
//   and 4 * dec_base from bit 13 (dec_base < 2^15).  Then a step is one
//   shared load, a funnel shift of E = D_hi >> 1 by the entry (its low five
//   bits: 31 - nb, so E >> (31 - nb) is the top nb bits, 0 for nb = 0), and
//   one multiply-add to the next entry's byte offset; the container's shift
//   and refill run while the next entry loads.  A larger table is read from
//   global memory, where the L2 holds it, with its symbol, as int32 entries
//   nb | dec_base << 5 up to table_log 26 and int64 from 27 (the kernel is
//   templated on where the tables live and on the entry's width).
// - Stores go straight from the walk into the (max_rem, n_lanes) plane
//   layout, 32 contiguous bytes a warp a row; K4 puts them back into symbol
//   order.
// - Blocks of 256 lanes, or of 128 where 128-lane blocks are at most one per
//   SM (repro_fse_decode asks the device for its SM count), so that the
//   16,384- and 4096-lane launches of the decode path still reach every SM.
#define FSE_DEC_RING 16    // 16-byte slots in a lane's ring
#define FSE_DEC_ROUND 8    // steps between two rounds of ring copies
#define FSE_DEC_PENDING 5  // rounds whose copies may be in flight after a round's wait
static_assert((4 * FSE_DEC_RING - 11) / FSE_DEC_ROUND >= FSE_DEC_PENDING + 1,
              "a ring vector must land before a lane can reach it");

template <int kLanes, bool kSharedTable, typename Entry>
__global__ void __launch_bounds__(kLanes)
fse_decode_kernel(const uint8_t* __restrict__ buf, long long n_bytes,
                  const long long* __restrict__ lane_base, const long long* __restrict__ bitlen,
                  const int* __restrict__ state0, const uint8_t* __restrict__ sym,
                  const Entry* __restrict__ nbb, uint8_t* __restrict__ out, int max_rem,
                  long long n_lanes, int total) {
  constexpr int kRingBytes = kLanes * FSE_DEC_RING * 16;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint8_t* s_tab = smem + kRingBytes;
  const int t = threadIdx.x;
  if (kSharedTable)
    for (int i = t; i < total; i += kLanes) {
      const uint32_t e = (uint32_t)nbb[i];
      reinterpret_cast<uint32_t*>(smem + kRingBytes)[i] =
          (31u - (e & 31u)) | ((uint32_t)sym[i] << 5) | ((e >> 5) << 15);
    }
  const long long lane = (long long)blockIdx.x * kLanes + t;
  const bool live = lane < n_lanes;
  const uint8_t* end = buf + n_bytes;
  const uint8_t* lb = buf + (live ? lane_base[lane] : 0);
  const long long bl = live ? bitlen[lane] : 0;
  const uint8_t* top = lb + ((bl - 1) >> 3);  // the byte of the last bit (empty: the one before)
  LaneRing<FSE_DEC_RING, false> ring{reinterpret_cast<uint32_t*>(smem) + 4 * FSE_DEC_RING * t,
                                     (const uint8_t*)((uintptr_t)top & ~(uintptr_t)15), t & 7u, 0};
  if (live) ring.fill<FSE_DEC_RING>(0, buf, end);
  cp_async_commit();
  cp_async_wait<0>();
  if (kSharedTable) __syncthreads();  // the table is in place
  if (!live) return;

  // the clamped reads: the lane's first five bytes
  uint32_t f_lo = 0, f_hi = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint8_t* q = lb + k;
    const uint32_t b = q >= buf && q < end ? *q : 0u;
    if (k < 4) f_lo |= b << (8 * k);
    else f_hi = b;
  }
  // the container: the bits below the lane's end, left-aligned; the bits
  // under the avail held ones are zero, and avail stays below 64, so that a
  // refill is avail |= 32 (one word where two would fill the container)
  const unsigned excess = 31u - ((((unsigned)(uintptr_t)top & 3u) << 3) | (unsigned)((bl - 1) & 7));
  unsigned d = 3u - (unsigned)(((uintptr_t)top & 15) >> 2);  // the ring word of the last bit
  const uint32_t w0 = ring.word(ring.index(d));
  const uint32_t w1 = excess ? ring.word(ring.index(d + 1)) : 0u;
  uint32_t Dhi = __funnelshift_l(w1, w0, excess), Dlo = w1 << excess;
  int avail = excess ? 64 - (int)excess : 32;
  unsigned wi = ring.index(d + (excess ? 2 : 1));
  uint32_t w_next = ring.word(wi);
  // the cursor, from where the container's lowest bit lies: word d - 1, at
  // v0 + 16 - 4d, was the last to go in
  const long long c_base = 8 * (ring.v0 - lb + 16);
  const auto cursor = [&]() { return c_base - 32ll * ring.word_of(wi) + avail; };
  long long c = bl;
  uint32_t state = (uint32_t)state0[lane] * (kSharedTable ? 4u : 1u);  // shared: a byte offset
  uint8_t* o = out + lane;

  // Step j of a round, without a branch: every step reads the ring's next
  // word for the next one.  `clamp`: the cursor may fall below the lane's
  // start within this round, so it is tracked and the clamped read selected.
  auto step = [&](int j, const bool clamp) {
    uint32_t nb, t_nb, symbol, base;
    if constexpr (kSharedTable) {
      const uint32_t e = *reinterpret_cast<const uint32_t*>(s_tab + state);
      t_nb = e;  // 31 - nb in the low five bits
      nb = ~e & 31u;
      symbol = e >> 5;  // the store keeps its low byte
      base = e >> 13;   // 4 * dec_base
    } else {
      const Entry e = nbb[state];
      nb = (uint32_t)e & 31u;
      t_nb = ~nb;  // 31 - nb mod 32
      symbol = sym[state];
      base = (uint32_t)(e >> 5);
    }
    // E >> (31 - nb), E = D_hi >> 1: the top nb bits of D (0 for nb = 0)
    uint32_t value = __funnelshift_r(Dhi >> 1, 0u, t_nb);
    if (clamp) {
      c -= nb;
      if (c < 0) value = __funnelshift_r(f_lo, f_hi, (uint32_t)c & 7u) & ((1u << nb) - 1u);
    }
    state = base + (kSharedTable ? value << 2 : value);
    Dhi = __funnelshift_l(Dlo, Dhi, nb);  // D <<= nb
    Dlo <<= nb;
    avail -= (int)nb;
    const uint32_t w = avail < 32 ? w_next : 0u;  // a refill, under the held bits
    Dlo |= __funnelshift_l(0u, w, (unsigned)-avail);  // w << (32 - avail)
    Dhi |= __funnelshift_r(w, 0u, avail);             // w >> avail
    wi -= avail < 32;
    avail |= 32;
    w_next = ring.word(wi);
    o[(long long)j * n_lanes] = (uint8_t)symbol;
  };

  int i = 0;
  for (; i + FSE_DEC_ROUND <= max_rem; i += FSE_DEC_ROUND) {
    if (i) {
      ring.fill<FSE_DEC_ROUND / 4>(ring.word_of(wi) >> 2, buf, end);
      cp_async_commit();
      cp_async_wait<FSE_DEC_PENDING>();
    }
    // a round takes at most 30 * FSE_DEC_ROUND bits; the warp clamps if one
    // of its lanes may reach its start
    c = cursor();
    if (__any_sync(__activemask(), c < 32 * FSE_DEC_ROUND)) {
#pragma unroll
      for (int j = 0; j < FSE_DEC_ROUND; ++j) step(j, true);
    } else {
#pragma unroll
      for (int j = 0; j < FSE_DEC_ROUND; ++j) step(j, false);
    }
    o += (long long)FSE_DEC_ROUND * n_lanes;
  }
  c = cursor();
  for (; i < max_rem; ++i, o += n_lanes) step(0, true);
}

template <int kLanes, bool kSharedTable, typename Entry>
static int launch_decode(const void* buf, long long n_bytes, const void* lane_base,
                         const void* bitlen, const void* state0, const void* sym,
                         const void* nbb, void* out, int max_rem, long long n_lanes, int total,
                         cudaStream_t stream) {
  constexpr int kRingBytes = kLanes * FSE_DEC_RING * 16;
  const size_t smem = kRingBytes + (kSharedTable ? (size_t)total * sizeof(uint32_t) : 0);
  // the limit for the largest shared table; a launch takes what its table needs
  cudaError_t err = cudaFuncSetAttribute(
      fse_decode_kernel<kLanes, kSharedTable, Entry>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes + (kSharedTable ? FSE_SHARED_TABLE * (int)sizeof(uint32_t) : 0));
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_lanes + kLanes - 1) / kLanes;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fse_decode_kernel<kLanes, kSharedTable, Entry><<<(unsigned int)blocks, kLanes, smem, stream>>>(
      (const uint8_t*)buf, n_bytes, (const long long*)lane_base, (const long long*)bitlen,
      (const int*)state0, (const uint8_t*)sym, (const Entry*)nbb, (uint8_t*)out, max_rem,
      n_lanes, total);
  return (int)cudaGetLastError();
}

// entry_bytes is 4 (nb | dec_base << 5 in a u32, table_log <= 26) or 8 (u64)
template <int kLanes>
static int decode_tables(const void* buf, long long n_bytes, const void* lane_base,
                         const void* bitlen, const void* state0, const void* sym,
                         const void* nbb, void* out, int max_rem, long long n_lanes, int total,
                         int entry_bytes, cudaStream_t s) {
  if (entry_bytes == 8)
    return launch_decode<kLanes, false, unsigned long long>(
        buf, n_bytes, lane_base, bitlen, state0, sym, nbb, out, max_rem, n_lanes, total, s);
  if (entry_bytes != 4) return (int)cudaErrorInvalidValue;
  if (total <= FSE_SHARED_TABLE)
    return launch_decode<kLanes, true, uint32_t>(buf, n_bytes, lane_base, bitlen, state0, sym,
                                                 nbb, out, max_rem, n_lanes, total, s);
  return launch_decode<kLanes, false, uint32_t>(buf, n_bytes, lane_base, bitlen, state0, sym,
                                                nbb, out, max_rem, n_lanes, total, s);
}

REPRO_API int repro_fse_decode(const void* buf, long long n_bytes, const void* lane_base,
                               const void* bitlen, const void* state0, const void* sym,
                               const void* nbb, void* out, int max_rem, long long n_lanes,
                               int total, int entry_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (max_rem < 1 || n_lanes < 1 || n_bytes < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes <= 128LL * sms)
    return decode_tables<128>(buf, n_bytes, lane_base, bitlen, state0, sym, nbb, out, max_rem,
                              n_lanes, total, entry_bytes, s);
  return decode_tables<256>(buf, n_bytes, lane_base, bitlen, state0, sym, nbb, out, max_rem,
                            n_lanes, total, entry_bytes, s);
}
