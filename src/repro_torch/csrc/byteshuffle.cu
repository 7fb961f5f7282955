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
// It runs the `transpose` decoder (w = the numeric width, n up to 2^25), and
// it puts the entropy decoders' (max_rem, n_lanes) lane output back into
// symbol order (w = max_rem, up to 4096, with n as small as one lane).
//
// Bound: bytes (n*w read, n*w written, no arithmetic), so the vector paths
// move 16-byte vectors with streaming loads and stores (ld/st.global.cs: each
// byte is touched once).  The host picks the path from w and the output
// pointer (which the wrapper allocates, so it is 16-byte aligned):
//
// - narrow (w in {1, 2, 4, 8}): a thread reads 16 bytes from each plane at
//   the same record offset (16 records) and transposes them in registers
//   with __byte_perm into its 16*w output bytes.  A warp's output is one
//   contiguous run of 512*w bytes; the warp stages it through shared memory
//   (16-byte chunks, XOR-swizzled so that neither side conflicts on banks)
//   so that each store instruction covers 512 contiguous bytes.  w = 1 is a
//   vector copy.  One thread per group of 16 records, no loop; the last
//   n % 16 records are spread over the lanes of the warp that holds them.
// - wide (w % 16 == 0): a block transposes 128 planes by 128 records (16 KiB)
//   per tile.  A thread reads 16 bytes from each of four planes and
//   transposes the four 4 x 4 byte blocks in registers (a word then holds
//   one record's bytes of four planes); the words go to a swizzled shared
//   tile, from which a thread gathers the four words of one record that
//   cover 16 planes and writes them as one 16-byte store, eight threads
//   covering a record's 128 contiguous bytes.  Tiles are walked by a
//   grid-stride loop sized to the card: two barriers per 16 KiB.  A plane's
//   last partial group of 16 records is read byte by byte.
// - any other w (3, 33, or max_rem symbols in a single lane): a byte-wise
//   tile transpose through shared memory, UP planes by UN records per tile,
//   read plane-major and written record-major.
//
// A plane starts at p + c*n, which is 16-byte aligned only when p is and
// n % 16 == 0.  Both vector paths read a plane's 16 bytes through load16:
// one aligned vector where the start is aligned, else the two aligned
// vectors that hold the bytes, joined with funnel shifts.  The shift is one
// per plane, so in the narrow path it is the same in every thread.

// a, b, c, d: four planes' bytes of the same four records -> o[j]: record j's
// bytes of the four planes, a's in byte 0.
__device__ __forceinline__ void transpose4x4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                             uint32_t* o) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  o[0] = __byte_perm(ab_lo, cd_lo, 0x5410);          // a0 b0 c0 d0
  o[1] = __byte_perm(ab_lo, cd_lo, 0x7632);          // a1 b1 c1 d1
  o[2] = __byte_perm(ab_hi, cd_hi, 0x5410);          // a2 b2 c2 d2
  o[3] = __byte_perm(ab_hi, cd_hi, 0x7632);          // a3 b3 c3 d3
}

// The 16 bytes at a, all of them in bounds, as four words.  An aligned a is
// one streaming vector load.  Otherwise the two aligned vectors that hold the
// bytes are read (each holds at least one of them, so neither leaves the
// allocation: device memory is mapped in granules far larger than 16 bytes)
// and their words are joined at the byte offset (join_at).  The
// second vector is the next thread's first, so both go through L1 (ld.nc).
__device__ __forceinline__ void load16(const uint8_t* a, uint32_t* o) {
  const unsigned s = (unsigned)((uintptr_t)a & 15);
  const uint4* v = reinterpret_cast<const uint4*>(a - s);
  if (s == 0) {
    words_of(__ldcs(v), o);
    return;
  }
  uint32_t b[8];
  words_of(__ldg(v), b);
  words_of(__ldg(v + 1), b + 4);
  join_at<4>(b, s, o);
}

#define NARROW_THREADS 256

// in[c][k]: bytes 4k..4k+3 of plane c's 16 records -> o: the 16 records'
// W bytes each, in output order, as 4*W words.
template <int W>
__device__ __forceinline__ void records16(uint32_t (*in)[4], uint32_t* o) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (W == 1) {
      o[k] = in[0][k];
    } else if constexpr (W == 2) {
      o[2 * k] = __byte_perm(in[0][k], in[1][k], 0x5140);
      o[2 * k + 1] = __byte_perm(in[0][k], in[1][k], 0x7362);
    } else if constexpr (W == 4) {
      transpose4x4(in[0][k], in[1][k], in[2][k], in[3][k], o + 4 * k);
    } else {  // W == 8: a record is the words of planes 0-3 and 4-7
      uint32_t lo[4], hi[4];
      transpose4x4(in[0][k], in[1][k], in[2][k], in[3][k], lo);
      transpose4x4(in[4][k], in[5][k], in[6][k], in[7][k], hi);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[8 * k + 2 * i] = lo[i];
        o[8 * k + 2 * i + 1] = hi[i];
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(NARROW_THREADS)
byteunshuffle_narrow_kernel(const uint8_t* __restrict__ p, uint8_t* __restrict__ out,
                            long long n, long long groups) {
  constexpr int WARPS = NARROW_THREADS / 32;
  __shared__ uint4 stage[WARPS][W == 1 ? 1 : 32 * W];
  const int lane = threadIdx.x & 31;
  // this warp: 16-record groups base..base+31, output chunks base*W.. (16 bytes each)
  const long long base = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32;
  const int tail = (int)(n - 16 * groups);  // records past the last full group
  if (base > groups || (base == groups && tail == 0)) return;  // the whole warp
  const long long g = base + lane;
  uint4* dst = reinterpret_cast<uint4*>(out) + base * W;
  uint32_t o[4 * W];
  if (g < groups) {
    uint32_t in[W][4];
#pragma unroll
    for (int c = 0; c < W; ++c) load16(p + c * n + 16 * g, in[c]);
    records16<W>(in, o);
  }
  if constexpr (W == 1) {
    if (g < groups) __stcs(dst + lane, make_uint4(o[0], o[1], o[2], o[3]));
  } else {
    uint4* st = stage[threadIdx.x >> 5];
    if (g < groups) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        st[stage_slot(lane * W + j)] =
            make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
    }
    __syncwarp();
    const long long live = (groups - base) * W;  // chunks of this warp still in range
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int ci = 32 * k + lane;
      if (ci < live) __stcs(dst + ci, st[stage_slot(ci)]);
    }
  }
  if (tail && base + 32 > groups) {  // the last n % 16 records: at most 15*W bytes
    const long long r0 = 16 * groups;
#pragma unroll
    for (int k = 0; k < (15 * W + 31) / 32; ++k) {
      const int i = 32 * k + lane;
      if (i < tail * W) out[r0 * W + i] = p[(i % W) * n + r0 + i / W];
    }
  }
}

#define WT 128  // planes and records of a wide tile

// The physical 16-byte chunk of logical chunk cc (records 4cc..4cc+3) in row
// q (planes 4q..4q+3) of the wide tile.  A quarter-warp writes one row's
// chunks 4rg + k for rg = 0..7, and reads one chunk of rows q = 4g + i for
// g = 0..7: XORing in cc's bits 2-4 and q's bits 2-4 spreads both over the
// eight bank groups.
__device__ __forceinline__ int wide_slot(int q, int cc) {
  return cc ^ ((cc >> 2) & 7) ^ ((q >> 2) & 7);
}

__global__ void __launch_bounds__(256)
byteunshuffle_wide_kernel(const uint8_t* __restrict__ p, uint8_t* __restrict__ out,
                          long long n, long long w, long long record_tiles, long long tiles) {
  // tile[q][slot]: the words of planes 4q..4q+3 for the tile's 128 records
  __shared__ uint4 tile[WT / 4][WT / 4];
  const int t = threadIdx.x;
  for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const long long r0 = (tt % record_tiles) * WT;
    const long long c0 = (tt / record_tiles) * WT;
    {  // planes 4q..4q+3 of records 16rg..16rg+15
      const int q = t >> 3, rg = t & 7;
      const long long c = c0 + 4 * q, r = r0 + 16 * rg;
      if (c < w && r < n) {
        uint32_t v[4][4];
        if (r + 16 <= n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) load16(p + (c + i) * n + r, v[i]);
        } else {  // the planes' last, partial group: byte by byte, zero past n
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              uint32_t word = 0;
#pragma unroll
              for (int b = 0; b < 4; ++b)
                if (r + 4 * k + b < n) word |= (uint32_t)p[(c + i) * n + r + 4 * k + b] << (8 * b);
              v[i][k] = word;
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t o[4];
          transpose4x4(v[0][k], v[1][k], v[2][k], v[3][k], o);
          tile[q][wide_slot(q, 4 * rg + k)] = make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
    __syncthreads();
    {  // record rr's planes 16g..16g+15: the words of rows 4g..4g+3
      const int g = t & 7;
      const long long c = c0 + 16 * g;
#pragma unroll
      for (int rr = t >> 3; rr < WT; rr += 32) {
        const long long r = r0 + rr;
        if (c < w && r < n) {
          uint32_t o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = 4 * g + i;
            o[i] = reinterpret_cast<const uint32_t*>(&tile[q][wide_slot(q, rr >> 2)])[rr & 3];
          }
          __stcs(reinterpret_cast<uint4*>(out + r * w + c), make_uint4(o[0], o[1], o[2], o[3]));
        }
      }
    }
    __syncthreads();
  }
}

#define UP 32   // planes per tile of the byte-wise path
#define UN 256  // records per tile of the byte-wise path

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

// One thread per 16-record group, one warp per 512 records, no loop; a
// partial last group adds one thread.
template <int W>
static void launch_narrow(const void* p, void* out, long long n, cudaStream_t s) {
  const long long groups = n / 16;
  byteunshuffle_narrow_kernel<W><<<repro_grid((n + 15) / 16, NARROW_THREADS, 0x7FFFFFFFLL),
                                   NARROW_THREADS, 0, s>>>((const uint8_t*)p, (uint8_t*)out,
                                                           n, groups);
}

REPRO_API int repro_byteunshuffle(const void* p, void* out, long long w, long long n,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)out % 16 == 0;
  if (vec && (w == 1 || w == 2 || w == 4 || w == 8)) {
    switch (w) {
      case 1: launch_narrow<1>(p, out, n, s); break;
      case 2: launch_narrow<2>(p, out, n, s); break;
      case 4: launch_narrow<4>(p, out, n, s); break;
      default: launch_narrow<8>(p, out, n, s); break;
    }
    return (int)cudaGetLastError();
  }
  if (vec && w % 16 == 0) {
    const long long record_tiles = (n + WT - 1) / WT;
    const long long tiles = record_tiles * ((w + WT - 1) / WT);
    byteunshuffle_wide_kernel<<<repro_grid(tiles, 1, 132 * 8), 256, 0, s>>>(
        (const uint8_t*)p, (uint8_t*)out, n, w, record_tiles, tiles);
    return (int)cudaGetLastError();
  }
  const long long record_tiles = (n + UN - 1) / UN;
  const long long tiles = record_tiles * ((w + UP - 1) / UP);
  byteunshuffle_kernel<<<repro_grid(tiles, 1, 132 * 16), 256, 0, s>>>(
      (const uint8_t*)p, (uint8_t*)out, n, w, record_tiles, tiles);
  return (int)cudaGetLastError();
}
