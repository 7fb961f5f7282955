// K3 — byte shuffle: (n, w) uint8 records -> (w, n) byte planes, for any
// w >= 1, any n >= 1 and any input offset.
//
// Replaces the TPU kernel src/repro/kernels/byteshuffle.py, byteshuffle_pallas
// (_shuffle_kernel), which transposed (2048, w) VMEM tiles in grid order.
// It runs the `transpose` encoder (w = the numeric width, 1 to 8) and lays
// out the tANS lanes before K9, (n_lanes, 1024) -> (1024, n_lanes), so the
// fse encoder's input never leaves the card.
//
// Bound: bytes (n*w read, n*w written, no arithmetic).  It mirrors K4 below
// (same helpers, same three paths), with the host choosing the path from w
// (kernels/ops.py, byteshuffle_path):
//
// - narrow (w in {1, 2, 4, 8}): a warp owns 512 records, 512*w contiguous
//   bytes.  It reads them as 16-byte vectors (load16, so the input may start
//   at any byte), lane l taking chunks l, l + 32, ..., through a swizzled
//   warp stage (stage_slot), so that each load instruction covers 512
//   contiguous bytes.  Lane l then takes its 16 records from the stage,
//   transposes them in registers with __byte_perm (planes16, the inverse of
//   K4's records16) and holds one 16-byte vector of each plane; a warp's
//   store to a plane is one run of 512 contiguous bytes.
// - wide (w % 16 == 0; the tANS lanes' w = 1024): a block transposes 128
//   records by 128 columns (16 KiB) per tile, the tiles walked by a
//   grid-stride loop sized to the card.  A thread reads 16 bytes of each of
//   four records, transposes the four 4 x 4 byte blocks in registers (a word
//   then holds one column's bytes of four records) and puts the words into
//   a padded, XOR-swizzled shared tile; each output vector is then 16
//   records of one column.
// - any other w: a byte-wise tile transpose through shared memory, TR
//   records by TC columns per tile.
//
// The store side is where K3 differs from K4: plane c starts at out + c*n,
// 16-byte aligned only when n % 16 == 0, and a ragged n is the rule (a lane
// count ceil(n / 1024), a column of any length).  So both vector paths
// write every plane's run as the aligned 16-byte vectors that lie wholly
// inside it, and its first and last partial vectors byte by byte: the
// narrow path builds each aligned vector from its lane's bytes and the
// previous lane's (one warp shuffle per word, joined with funnel shifts),
// the wide path reads it from the tile at the run's byte offset.  Neither
// path has a size or alignment window: any n and any input offset take it.

#include "common.cuh"

// a, b, c, d: the four rows of a 4 x 4 byte block -> o[j]: byte j of each
// row, a's in byte 0 (the block transposed).  K4 turns four planes' bytes of
// four records into the records' bytes with it, K3 the reverse.
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
#define WT 128  // records and columns (K3), planes and records (K4) of a wide tile

// The K3 vector paths, as kernels/ops.py chooses them from w.
#define SHUFFLE_NARROW 0
#define SHUFFLE_WIDE 1
#define SHUFFLE_BYTES 2

// o: 16 records of W bytes, record-major, as 4*W words -> in[c][k]: bytes
// 4k..4k+3 of plane c over the 16 records.  The inverse of records16 (K4).
template <int W>
__device__ __forceinline__ void planes16(const uint32_t* o, uint32_t (*in)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (W == 1) {
      in[0][k] = o[k];
    } else if constexpr (W == 2) {  // records 4k..4k+3 are the bytes of o[2k], o[2k+1]
      in[0][k] = __byte_perm(o[2 * k], o[2 * k + 1], 0x6420);
      in[1][k] = __byte_perm(o[2 * k], o[2 * k + 1], 0x7531);
    } else if constexpr (W == 4) {
      uint32_t t[4];
      transpose4x4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3], t);
#pragma unroll
      for (int c = 0; c < 4; ++c) in[c][k] = t[c];
    } else {  // W == 8: record j is the words o[8k + 2j] (bytes 0-3) and o[8k + 2j + 1]
      uint32_t lo[4], hi[4];
      transpose4x4(o[8 * k], o[8 * k + 2], o[8 * k + 4], o[8 * k + 6], lo);
      transpose4x4(o[8 * k + 1], o[8 * k + 3], o[8 * k + 5], o[8 * k + 7], hi);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        in[c][k] = lo[c];
        in[4 + c][k] = hi[c];
      }
    }
  }
}

// Record rr's byte c, from a warp's stage of its 512 records.
template <int W>
__device__ __forceinline__ uint8_t staged_byte(const uint4* st, int rr, int c) {
  const int i = rr * W + c;
  return reinterpret_cast<const uint8_t*>(st + stage_slot(i >> 4))[i & 15];
}

template <int W, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
byteshuffle_narrow_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                          long long n, long long groups) {
  __shared__ uint4 stage[WARPS][W == 1 ? 1 : 32 * W];
  const int lane = threadIdx.x & 31;
  // this warp: 16-record groups base..base+31, input chunks base*W.. (16 bytes each)
  const long long base = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32;
  const int tail = (int)(n - 16 * groups);  // records past the last full group
  if (base > groups || (base == groups && tail == 0)) return;  // the whole warp
  const int live = (int)(groups - base < 32 ? groups - base : 32);  // its full groups
  const uint8_t* src = x + base * 16 * W;
  uint4* st = stage[threadIdx.x >> 5];
  uint32_t in[W][4] = {};
  if constexpr (W == 1) {
    if (lane < live) load16(src + 16 * lane, in[0]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int ci = 32 * k + lane;
      if (ci < live * W) {
        uint32_t v[4];
        load16(src + 16 * ci, v);
        st[stage_slot(ci)] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncwarp();
    if (lane < live) {
      uint32_t o[4 * W];
#pragma unroll
      for (int j = 0; j < W; ++j) words_of(st[stage_slot(lane * W + j)], o + 4 * j);
      planes16<W>(o, in);
    }
  }
#pragma unroll
  for (int c = 0; c < W; ++c) {
    uint8_t* run = out + c * n + 16 * base;  // this warp's 16 * live bytes of plane c
    const int sc = (int)((uintptr_t)run & 15);  // the same in every lane
    if (sc == 0) {
      if (lane < live)
        __stcs(reinterpret_cast<uint4*>(run) + lane,
               make_uint4(in[c][0], in[c][1], in[c][2], in[c][3]));
    } else if constexpr (W > 1) {
      // the aligned vector at run + 16*lane - sc: the previous lane's last sc
      // bytes, then this lane's first 16 - sc
      uint32_t b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[i] = __shfl_up_sync(0xffffffffu, in[c][i], 1);
        b[4 + i] = in[c][i];
      }
      if (lane >= 1 && lane < live) {
        uint32_t o[4];
        join_at<4>(b, 16 - sc, o);
        __stcs(reinterpret_cast<uint4*>(run + 16 * lane - sc), make_uint4(o[0], o[1], o[2], o[3]));
      }
      if (live) {  // the partial first and last vectors, byte by byte from the stage
        if (lane < 16 - sc) run[lane] = staged_byte<W>(st, lane, c);
        if (lane < sc) run[16 * live - sc + lane] = staged_byte<W>(st, 16 * live - sc + lane, c);
      }
    }
  }
  if (tail && base + 32 > groups) {  // the last n % 16 records: at most 15*W bytes
    const long long r0 = 16 * groups;
#pragma unroll
    for (int k = 0; k < (15 * W + 31) / 32; ++k) {
      const int i = 32 * k + lane;
      if (i < tail * W) out[(i % W) * n + r0 + i / W] = x[r0 * W + i];
    }
  }
}

// A wide tile's column row holds the words of records r0 - 16 .. r0 + 127,
// four records a word: logical word a (0..35) is physical word
// wide_word(a, sw).  The head (a < 4, records r0 - 16..r0 - 1, read only
// where n % 16 != 0) sits at words 32..35; the main words are XORed with
// sw = (column / 16) * 4.  A warp writes the words of columns 16j + e (j =
// 0..7, e fixed) for four record quads; the XOR and the row pitch of 37
// words put those 32 main words in 32 banks.
#define WIDE_PITCH (WT / 4 + 5)

__device__ __forceinline__ int wide_word(int a, int sw) {
  return a < 4 ? 32 + a : (a - 4) ^ sw;
}

__global__ void __launch_bounds__(256)
byteshuffle_wide_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, long long n,
                        long long w, long long record_tiles, long long tiles) {
  __shared__ uint32_t tile[WT][WIDE_PITCH];
  const int t = threadIdx.x;
  // column c's plane starts at out + c*n, 16-byte aligned in every column
  // only where n % 16 == 0; otherwise each tile also reads the 16 records
  // before it, so that every aligned vector of a plane lies in one tile
  const int first = (n & 15) ? 0 : 4 * 8;
  for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const long long r0 = (tt % record_tiles) * WT;
    const long long c0 = (tt / record_tiles) * WT;
    // columns 16j..16j+15 of the four records of logical word a: eight
    // threads read a record's 128 contiguous bytes
    for (int p = first + t; p < (WT / 4 + 4) * 8; p += 256) {
      const int a = p >> 3, j = p & 7;
      const long long c = c0 + 16 * j;
      const long long r = r0 - 16 + 4 * a;
      if (c >= w || r >= n || r + 4 <= 0) continue;
      uint32_t v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r + i >= 0 && r + i < n) {
          load16(x + (r + i) * w + c, v[i]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[i][k] = 0;
        }
      }
      const int word = wide_word(a, j << 2);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t o[4];
        transpose4x4(v[0][m], v[1][m], v[2][m], v[3][m], o);
#pragma unroll
        for (int k = 0; k < 4; ++k) tile[16 * j + 4 * m + k][word] = o[k];
      }
    }
    __syncthreads();
    // column cc's aligned vectors b = 0..7 from the one that holds record
    // r0 - s (s = the plane's offset in its vector): records rl..rl+15,
    // logical tile bytes 16 - s + 16b..; whole vectors stream out, the
    // partial ones at the plane's two ends go byte by byte
    for (int item = t; item < WT * 8; item += 256) {
      const int cc = item >> 3, b = item & 7;
      const long long c = c0 + cc;
      if (c >= w) continue;
      uint8_t* plane = out + c * n;
      const int s = (int)((uintptr_t)(plane + r0) & 15);
      const long long rl = r0 - s + 16 * b;
      if (rl >= n) continue;
      const uint32_t* row = tile[cc];
      const int sw = (cc >> 4) << 2;
      const int o = 16 - s + 16 * b;
      if (rl >= 0 && rl + 16 <= n) {
        const int a0 = o >> 2, sh = 8 * (o & 3);
        uint32_t u[5];
#pragma unroll
        for (int i = 0; i < 4; ++i) u[i] = row[wide_word(a0 + i, sw)];
        u[4] = sh ? row[wide_word(a0 + 4, sw)] : 0;  // a0 + 4 <= 35
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __funnelshift_r(u[k], u[k + 1], sh);
        __stcs(reinterpret_cast<uint4*>(plane + rl), make_uint4(v[0], v[1], v[2], v[3]));
      } else {
        for (int k = 0; k < 16; ++k) {
          if (rl + k < 0 || rl + k >= n) continue;
          const int ob = o + k;
          plane[rl + k] = (uint8_t)(row[wide_word(ob >> 2, sw)] >> (8 * (ob & 3)));
        }
      }
    }
    __syncthreads();
  }
}

#define TR 256  // records per tile of the byte-wise path
#define TC 32   // columns per tile of the byte-wise path

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

// One thread per 16-record group, one warp per 512 records, no loop; a
// partial last group adds one thread.  Eight warps a block, or two where
// that would leave fewer than two blocks per SM (a 64 KiB selector trial's
// 16 warps then spread over 8 SMs rather than 2).
template <int W>
static void launch_shuffle_narrow(const void* x, void* out, long long n, cudaStream_t s) {
  const long long threads = (n + 15) / 16;
  if ((threads + 31) / 32 >= 132 * 8 * 2) {
    byteshuffle_narrow_kernel<W, 8><<<repro_grid(threads, 256, 0x7FFFFFFFLL), 256, 0, s>>>(
        (const uint8_t*)x, (uint8_t*)out, n, n / 16);
  } else {
    byteshuffle_narrow_kernel<W, 2><<<repro_grid(threads, 64, 0x7FFFFFFFLL), 64, 0, s>>>(
        (const uint8_t*)x, (uint8_t*)out, n, n / 16);
  }
}

// path: SHUFFLE_NARROW, SHUFFLE_WIDE or SHUFFLE_BYTES, as the host chose it
// from w; a path whose precondition w (or an out that is not 16-byte
// aligned, for the vector paths) does not meet is refused, never swapped
REPRO_API int repro_byteshuffle(const void* x, void* out, long long n, long long w, int path,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (path != SHUFFLE_BYTES && (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  if (path == SHUFFLE_NARROW) {
    switch (w) {
      case 1: launch_shuffle_narrow<1>(x, out, n, s); break;
      case 2: launch_shuffle_narrow<2>(x, out, n, s); break;
      case 4: launch_shuffle_narrow<4>(x, out, n, s); break;
      case 8: launch_shuffle_narrow<8>(x, out, n, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  if (path == SHUFFLE_WIDE) {
    if (w % 16) return (int)cudaErrorInvalidValue;
    // a ragged n shifts each tile's vectors back by up to 15 records, so
    // the last tile may start within 15 records of the end
    const long long record_tiles = (n + (n % 16 ? 15 : 0) + WT - 1) / WT;
    const long long tiles = record_tiles * ((w + WT - 1) / WT);
    byteshuffle_wide_kernel<<<repro_grid(tiles, 1, 132 * 8), 256, 0, s>>>(
        (const uint8_t*)x, (uint8_t*)out, n, w, record_tiles, tiles);
    return (int)cudaGetLastError();
  }
  if (path != SHUFFLE_BYTES) return (int)cudaErrorInvalidValue;
  const long long row_tiles = (n + TR - 1) / TR;
  const long long col_tiles = (w + TC - 1) / TC;
  if (row_tiles > 0x7FFFFFFFLL || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)row_tiles, (unsigned int)col_tiles);
  byteshuffle_kernel<<<grid, 256, 0, s>>>((const uint8_t*)x, (uint8_t*)out, n, w);
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
