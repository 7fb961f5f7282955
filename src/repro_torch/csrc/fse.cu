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
// lane; all tables live in shared memory — the per-symbol nb0/thr/st0/norm
// and a compact encode table of exactly 2^table_log entries (the reference's
// (256, max norm) table packed symbol by symbol, located by sym_start) — so a
// step costs a few shared-memory loads.  The (max_rem, n_lanes) layout makes
// every step's symbol read and (value, nbits) write coalesced across the warp.
#include "common.cuh"

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
  for (int i = threadIdx.x; i < total; i += blockDim.x) s_enc[i] = enc[i];
  __syncthreads();

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
      state = xp < s_norm[s] ? s_enc[s_start[s] + xp] : 0;
    } else if (r == i + 1) {
      state = s_st0[s];
    }
  }
  state_out[lane] = state;
}

REPRO_API int repro_fse_encode(const void* lanesT, const void* rem, const void* nb0,
                               const void* thr, const void* st0, const void* norm,
                               const void* sym_start, const void* enc, void* vals,
                               void* nbs, void* state, int max_rem, long long n_lanes,
                               int total, int width, void* stream) {
  const int threads = 128;
  const size_t smem = (size_t)(1280 + total) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      fse_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_lanes + threads - 1) / threads;
  fse_encode_kernel<<<(unsigned int)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)lanesT, (const int*)rem, (const int*)nb0, (const int*)thr,
      (const int*)st0, (const int*)norm, (const int*)sym_start, (const int*)enc,
      (int*)vals, (int*)nbs, (int*)state, max_rem, n_lanes, total, width);
  return (int)cudaGetLastError();
}
