// K9 — tANS (FSE) encode: the backward state walk of every 1024-symbol lane.
//
// Replaces the TPU kernel src/repro/kernels/fse.py, fse_encode_pallas
// (_encode_kernel), which ran 256 lanes per grid step as vector lanes.
//
// Per lane of length r (the wire fixes 1024 symbols per lane): the state
// starts at st0[s] at position r-1; for every earlier position i it emits the
// low nb = nb0[s] - (X < thr[s]) bits of X = state + total and steps to
// enc[s][(X >> nb) - norm[s]].  Outputs are the (value, nbits) planes in the
// (max_rem, n_lanes) layout and the final state of each lane; the suffix sums
// that place every emission in the concatenated wire layout, and the bit
// packer, stay PyTorch glue on the card (kernels/ref.py).
//
// Bound: latency.  Each lane is a chain of max_rem dependent table steps, so
// the kernel's floor is the lane walk, not its bytes.  Design: one thread per
// lane; the per-symbol nb0/thr/st0/norm and sym_start live in shared memory,
// and so does the compact encode table of exactly 2^table_log entries (the
// reference's (256, max norm) table packed symbol by symbol, located by
// sym_start) up to FSE_SHARED_TABLE entries — 136 KB with the rest at
// table_log 15, above 48 KB so the launch sets the attribute.  A larger
// table stays in global memory, where the card's L2 (50 MB) holds it after
// the first steps; the kernel is templated on where the table lives.  The
// (max_rem, n_lanes) layout makes every step's symbol read and (value,
// nbits) write coalesced across the warp.  X = state + total stays below
// 2^(table_log + 1) and is held in an int, so table_log is at most 30, the
// port's limit on both sides (kernels/ref.py FSE_MAX_TABLE_LOG).
#include "common.cuh"

#define FSE_SHARED_TABLE (1 << 15)  // the largest table held in shared memory

template <bool kSharedTable>
__global__ void fse_encode_kernel(const uint8_t* __restrict__ lanesT,
                                  const int* __restrict__ rem,
                                  const int* __restrict__ nb0,
                                  const int* __restrict__ thr,
                                  const int* __restrict__ st0,
                                  const int* __restrict__ norm,
                                  const int* __restrict__ sym_start,
                                  const int* __restrict__ enc, int* __restrict__ vals,
                                  int* __restrict__ nbs, int* __restrict__ state_out,
                                  int max_rem, long long n_lanes, int total, int width) {
  extern __shared__ int sm[];
  int* s_nb0 = sm;
  int* s_thr = sm + 256;
  int* s_st0 = sm + 512;
  int* s_norm = sm + 768;
  int* s_start = sm + 1024;
  int* s_enc = sm + 1280;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_nb0[i] = nb0[i];
    s_thr[i] = thr[i];
    s_st0[i] = st0[i];
    s_norm[i] = norm[i];
    s_start[i] = sym_start[i];
  }
  if (kSharedTable)
    for (int i = threadIdx.x; i < total; i += blockDim.x) s_enc[i] = enc[i];
  __syncthreads();
  const int* t_enc = kSharedTable ? s_enc : enc;

  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int r = rem[lane];
  int state = 0;
  for (int i = max_rem - 1; i >= 0; --i) {
    const long long at = (long long)i * n_lanes + lane;
    const int s = lanesT[at];
    const bool emit = r > i + 1;
    const int X = state + total;
    const int nb = s_nb0[s] - (X < s_thr[s] ? 1 : 0);
    const int nbe = emit ? nb : 0;
    vals[at] = (int)((unsigned int)X & ((1u << nbe) - 1u));
    nbs[at] = nbe;
    if (emit) {
      // clip as the reference does; entries past norm[s] are zero there
      int xp = (X >> nb) - s_norm[s];
      xp = xp < 0 ? 0 : (xp > width - 1 ? width - 1 : xp);
      state = xp < s_norm[s] ? t_enc[s_start[s] + xp] : 0;
    } else if (r == i + 1) {
      state = s_st0[s];
    }
  }
  state_out[lane] = state;
}

template <bool kSharedTable>
static int launch_encode(const void* lanesT, const void* rem, const void* nb0,
                         const void* thr, const void* st0, const void* norm,
                         const void* sym_start, const void* enc, void* vals, void* nbs,
                         void* state, int max_rem, long long n_lanes, int total,
                         int width, cudaStream_t stream) {
  const int threads = 128;
  const size_t smem = (size_t)(1280 + (kSharedTable ? total : 0)) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(fse_encode_kernel<kSharedTable>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_lanes + threads - 1) / threads;
  if (blocks < 1 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fse_encode_kernel<kSharedTable><<<(unsigned int)blocks, threads, smem, stream>>>(
      (const uint8_t*)lanesT, (const int*)rem, (const int*)nb0, (const int*)thr,
      (const int*)st0, (const int*)norm, (const int*)sym_start, (const int*)enc,
      (int*)vals, (int*)nbs, (int*)state, max_rem, n_lanes, total, width);
  return (int)cudaGetLastError();
}

REPRO_API int repro_fse_encode(const void* lanesT, const void* rem, const void* nb0,
                               const void* thr, const void* st0, const void* norm,
                               const void* sym_start, const void* enc, void* vals,
                               void* nbs, void* state, int max_rem, long long n_lanes,
                               int total, int width, void* stream) {
  if (total <= FSE_SHARED_TABLE)
    return launch_encode<true>(lanesT, rem, nb0, thr, st0, norm, sym_start, enc, vals,
                               nbs, state, max_rem, n_lanes, total, width,
                               (cudaStream_t)stream);
  return launch_encode<false>(lanesT, rem, nb0, thr, st0, norm, sym_start, enc, vals,
                              nbs, state, max_rem, n_lanes, total, width,
                              (cudaStream_t)stream);
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
