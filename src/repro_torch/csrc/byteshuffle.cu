// K3 — byte shuffle: (n, w) uint8 records -> (w, n) byte planes.
//
// Replaces the TPU kernel src/repro/kernels/byteshuffle.py, byteshuffle_pallas
// (_shuffle_kernel), which transposed (2048, w) VMEM tiles in grid order.
// The same kernel lays out the tANS lanes, (n_lanes, 1024) -> (1024, n_lanes),
// so the fse encoder's input never leaves the card.
//
// Bound: bytes (n*w read, n*w written, no arithmetic).  Design: a tiled
// transpose through shared memory.  A block owns TR records by TC byte
// columns; it reads the tile record-major (for w <= TC the tile is one
// contiguous run of TR*w bytes) and writes it plane-major (TR consecutive
// bytes per plane), so both sides of device memory are coalesced.  Any w >= 1
// works: wide records (w = 1024 for the tANS lanes) take several column
// tiles along gridDim.y.
#include "common.cuh"

#define TR 256  // records per tile
#define TC 32   // byte columns per tile

__global__ void byteshuffle_kernel(const uint8_t* __restrict__ x,
                                   uint8_t* __restrict__ out, long long n,
                                   long long w) {
  __shared__ uint8_t tile[TC][TR + 4];
  const long long r0 = (long long)blockIdx.x * TR;
  const long long c0 = (long long)blockIdx.y * TC;
  const int tr = (int)(n - r0 < TR ? n - r0 : TR);
  const int tc = (int)(w - c0 < TC ? w - c0 : TC);
  const int cells = tr * tc;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int r = idx / tc;
    const int c = idx - r * tc;
    tile[c][r] = x[(r0 + r) * w + c0 + c];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int c = idx / tr;
    const int r = idx - c * tr;
    out[(c0 + c) * n + r0 + r] = tile[c][r];
  }
}

REPRO_API int repro_byteshuffle(const void* x, void* out, long long n, long long w,
                                void* stream) {
  const long long row_tiles = (n + TR - 1) / TR;
  const long long col_tiles = (w + TC - 1) / TC;
  if (row_tiles < 1 || col_tiles < 1 || row_tiles > 0x7FFFFFFFLL || col_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)row_tiles, (unsigned int)col_tiles);
  byteshuffle_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)out, n, w);
  return (int)cudaGetLastError();
}

// K4 — byte unshuffle: (w, n) uint8 planes -> (n, w) records, the inverse of
// K3, for any w >= 1.
//
// Replaces the TPU kernel src/repro/kernels/byteshuffle.py,
// byteunshuffle_pallas (_shuffle_kernel on (w, 2048) VMEM tiles).
//
// It runs the `transpose` decoder, and it puts the entropy decoders'
// (max_rem, n_lanes) lane output back into symbol order (w = max_rem, up to
// 4096, with n as small as one lane).
//
// Bound: bytes (n*w read, n*w written, no arithmetic).  Design: a tiled
// transpose through shared memory.  A tile is UP planes by UN records; it is
// read plane-major (UN consecutive bytes per plane) and written record-major
// (for w <= UP the tile's output is one contiguous run of UN*w bytes), so both
// sides of device memory are coalesced.  The tiles are walked by a 1-D
// grid-stride loop, record tiles fastest, so no grid dimension limits n or w.
#define UP 32   // planes per tile
#define UN 256  // records per tile

__global__ void byteunshuffle_kernel(const uint8_t* __restrict__ p,
                                     uint8_t* __restrict__ out, long long n,
                                     long long w, long long record_tiles,
                                     long long tiles) {
  __shared__ uint8_t tile[UP][UN + 4];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = (t % record_tiles) * UN;
    const long long c0 = (t / record_tiles) * UP;
    const int tr = (int)(n - r0 < UN ? n - r0 : UN);
    const int tc = (int)(w - c0 < UP ? w - c0 : UP);
    const int cells = tr * tc;
    for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
      const int c = idx / tr;
      const int r = idx - c * tr;
      tile[c][r] = p[(c0 + c) * n + r0 + r];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
      const int r = idx / tc;
      const int c = idx - r * tc;
      out[(r0 + r) * w + c0 + c] = tile[c][r];
    }
    __syncthreads();
  }
}

REPRO_API int repro_byteunshuffle(const void* p, void* out, long long w, long long n,
                                  void* stream) {
  const long long record_tiles = (n + UN - 1) / UN;
  const long long tiles = record_tiles * ((w + UP - 1) / UP);
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  byteunshuffle_kernel<<<repro_grid(tiles, 1, 132 * 16), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)p, (uint8_t*)out, n, w, record_tiles, tiles);
  return (int)cudaGetLastError();
}
