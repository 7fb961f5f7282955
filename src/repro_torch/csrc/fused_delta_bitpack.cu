// K11 — fused delta + bitpack: d[i] = (x[i] - x[i-1]) mod 2^32 with
// x[-1] = 0, on the stream's values zero-extended to 32 bits, masked to
// `bits` and packed PER = 32 / bits to a word, LSB-first, in one pass.
//
// Replaces the TPU kernel src/repro/kernels/fused_delta_bitpack.py,
// fused_delta_bitpack_pallas (_fused_encode_kernel), which read the previous
// block's last value through a second block spec.
//
// Bound: bytes.  Reads n*w bytes and writes n*bits/8 bytes; the delta stream
// never reaches device memory.  Design: one thread per output word reads the
// predecessor of its first value, as K1 does (delta.cu), so no carry crosses
// blocks and they run in any order.  Slots of the last word past n are 0.
//
// K12 — fused decode: unpack, then the u32 inclusive prefix sum, cut to the
// output width on the store (equal to the reference's
// np.cumsum(d, dtype=np.uint32).astype(UNSIGNED[width])).
//
// Replaces fused_delta_bitpack.py, fused_delta_bitpack_decode_pallas
// (_fused_decode_sum_kernel, an XLA cumsum of the block sums, then
// _fused_decode_scan_kernel), whose carry relied on the grid running in order.
//
// Bound: bytes.  Reads n*bits/8 bytes and writes n*w bytes.  Design: one
// launch, K2's single-pass scan with decoupled look-back (scan.cuh) with the
// unpack in front of it, so the packed words are read once and the
// full-width delta stream never reaches device memory (the point of the TPU
// kernel).  A block of FTHREADS threads takes one tile (take_tile) of R
// sub-tiles; in each, a thread owns a run of VPT values, as many as keep
// both the run's input and its output within FRUN_BYTES (FDecode below).
// A thread loads all its R runs at once as streaming 16-byte vectors
// (load_run, shifted where the words are a view off the vector alignment;
// runs under one vector, 1 or 2 words, word by word) and sums each in
// registers; the block scans the R x FTHREADS run sums in value order
// (block_scan_runs), warp 0 looks back once for the sum of all earlier
// tiles (tiles_before), and each thread unpacks its runs again, adding from
// their bases, into output vectors that its warp stores as streaming
// 16-byte vectors through shared memory (stage_slot).  The last warp of
// the call reads and writes element by element.  A call is a memset of
// the scratch (ticket and statuses) and one kernel.
//
// Why R sub-tiles: a block idles its SM slot while warp 0 looks back, and
// at 8 bits to uint32 a run of 128 output bytes moves only 32 input bytes,
// so with one run a thread the look-back's wait was a large share of the
// kernel's time on an H100 (timed against a copy whose look-back returns a
// constant).  R runs a thread (FTILE_IN input and FTILE_OUT output bytes at
// most) spread it over R times the bytes; staging the input through shared
// memory as K2 does cost registers, and with them blocks an SM, and was
// slower here.
#include "bitpack.cuh"
#include "scan.cuh"

// ------------------------------------------------------------------ K11
template <typename T, int BITS>
__global__ void fused_delta_bitpack_kernel(const T* __restrict__ x,
                                           uint32_t* __restrict__ out, long long n,
                                           long long m) {
  constexpr int PER = Packing<BITS>::PER;
  constexpr uint32_t MASK = Packing<BITS>::MASK;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < m;
       w += stride) {
    const long long i0 = w * PER;
    uint32_t prev = i0 ? (uint32_t)x[i0 - 1] : 0u;
    uint32_t acc = 0;
    if (i0 + PER <= n) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const uint32_t cur = x[i0 + k];
        acc |= ((cur - prev) & MASK) << (k * BITS);
        prev = cur;
      }
    } else {
      for (int k = 0; i0 + k < n; ++k) {
        const uint32_t cur = x[i0 + k];
        acc |= ((cur - prev) & MASK) << (k * BITS);
        prev = cur;
      }
    }
    out[w] = acc;
  }
}

template <typename T, int BITS>
static int launch_encode(const void* x, void* out, long long n, cudaStream_t stream) {
  const long long m = (n + Packing<BITS>::PER - 1) / Packing<BITS>::PER;
  const int threads = 256;
  fused_delta_bitpack_kernel<T, BITS>
      <<<repro_grid(m, threads, 1LL << 20), threads, 0, stream>>>((const T*)x,
                                                                  (uint32_t*)out, n, m);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K12
#define FTHREADS 128
#define FRUN_BYTES 128   // a run's input and output bytes are each at most this
#define FTILE_OUT 512    // a thread's output bytes in a tile at most
#define FTILE_IN 128     // and its input bytes

// A K12 thread's work at BITS to values of type T: R runs, one in each of
// the tile's R sub-tiles, of VPT values in WPT words each (IN_V 16-byte
// vectors, 0 under one), written as OUT_V vectors (2, 4 or 8).
template <typename T, int BITS>
struct FDecode {
  static constexpr int W = (int)sizeof(T);
  static constexpr int PER = Packing<BITS>::PER;
  static constexpr int IN_VALUE_BYTES = BITS / 8 > 0 ? BITS / 8 : 1;
  static constexpr int VPT = FRUN_BYTES / (W > IN_VALUE_BYTES ? W : IN_VALUE_BYTES);
  static constexpr int WPT = VPT / PER;
  static constexpr int IN_V = WPT / 4;
  static constexpr int OUT_V = VPT * W / 16;
  static constexpr int R_IN = FTILE_IN / (4 * WPT), R_OUT = FTILE_OUT / (VPT * W);
  static constexpr int R = R_IN < R_OUT ? R_IN : R_OUT;
  static constexpr long long SUB = (long long)FTHREADS * VPT;  // values of a sub-tile
  static constexpr long long TILE = R * SUB;                    // and of a tile
  static_assert(WPT >= 1 && WPT * PER == VPT && (IN_V == 0 || IN_V * 4 == WPT),
                "a run is whole words, and whole vectors from four words");
  static_assert(OUT_V == 2 || OUT_V == 4 || OUT_V == 8, "the output stages as K6's does");
  static_assert(R >= 1, "a tile holds a sub-tile at least");
};

// The sum of a word's PER fields, mod 2^32.
template <int BITS>
__device__ __forceinline__ uint32_t field_sum(uint32_t word) {
  if constexpr (BITS == 1) {
    return __popc(word);
  } else if constexpr (BITS == 2) {
    return __popc(word & 0x55555555u) + 2 * __popc(word & 0xAAAAAAAAu);
  } else if constexpr (BITS == 4) {
    return __vsadu4((word & 0x0F0F0F0Fu) + ((word >> 4) & 0x0F0F0F0Fu), 0u);
  } else if constexpr (BITS == 8) {
    return __vsadu4(word, 0u);
  } else if constexpr (BITS == 16) {
    return (word & 0xFFFFu) + (word >> 16);
  } else {
    return word;
  }
}

// Output vector v of a run: values 4v*VPW .. 4v*VPW + 4VPW - 1 of it, cut to
// T, with *run the sum of the base and every field before them; *run moves
// past them.  VPW = 4 / sizeof(T) values to a word.
template <typename T, int BITS>
__device__ __forceinline__ uint4 scan_vector(const uint32_t* wd, int v, uint32_t* run) {
  using F = FDecode<T, BITS>;
  constexpr int VPW = 4 / F::W;
  constexpr uint32_t M = 0xFFFFFFFFu >> (32 - 8 * F::W);
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < VPW; ++q) {
      const int i = (4 * v + j) * VPW + q;
      *run += (wd[i / F::PER] >> (BITS * (i % F::PER))) & Packing<BITS>::MASK;
      word |= (*run & M) << (8 * F::W * q);
    }
    r[j] = word;
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// The exclusive prefix of each of a thread's R run sums in the block's
// order (sub-tile by sub-tile, thread by thread within one), and the
// block's total.  Every thread must call it, once per block.
template <int R>
__device__ __forceinline__ uint32_t block_scan_runs(const uint32_t* sum, uint32_t* before) {
  __shared__ uint32_t warp_sums[R][FTHREADS / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  uint32_t incl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t x = sum[r];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    incl[r] = x;
    if (lane == 31) warp_sums[r][wid] = x;
  }
  __syncthreads();
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t earlier = 0, all = 0;
#pragma unroll
    for (int w = 0; w < FTHREADS / 32; ++w) {
      const uint32_t x = warp_sums[r][w];
      earlier += w < wid ? x : 0u;
      all += x;
    }
    before[r] = acc + earlier + incl[r] - sum[r];
    acc += all;
  }
  return acc;
}

// Thread t's run in sub-tile r holds values g_r = tile*TILE + r*SUB + t*VPT
// onwards.  Every load of the tile is issued before any is used.
template <typename T, int BITS, bool SHIFTED>
__global__ void __launch_bounds__(FTHREADS)
fdb_decode_kernel(const uint32_t* __restrict__ words, T* __restrict__ out, long long n,
                  long long m, unsigned char* scratch) {
  using F = FDecode<T, BITS>;
  constexpr int R = F::R;
  __shared__ uint4 stage[FTHREADS / 32][32 * F::OUT_V];
  const long long tile = take_tile(scratch);
  const int lane = threadIdx.x & 31;
  uint4* st = stage[threadIdx.x >> 5];
  const uint8_t* end = reinterpret_cast<const uint8_t*>(words + m);
  uint32_t wd[R][F::WPT];
  uint32_t sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long g = tile * F::TILE + r * F::SUB + (long long)threadIdx.x * F::VPT;
    const long long gw = g - (long long)lane * F::VPT;  // the warp's first value
#pragma unroll
    for (int j = 0; j < F::WPT; ++j) wd[r][j] = 0;
    if (F::IN_V > 0 && gw + 32 * F::VPT <= n) {  // a full warp: vectors
      if constexpr (F::IN_V > 0)
        load_run<F::IN_V, SHIFTED>(reinterpret_cast<const uint8_t*>(words + g / F::PER), end,
                                   true, wd[r]);
    } else {  // runs under one vector, and the last warp: word by word, zero past m
      const long long w0 = g / F::PER;
#pragma unroll
      for (int j = 0; j < F::WPT; ++j)
        if (w0 + j < m) wd[r][j] = __ldcs(words + w0 + j);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sum[r] = 0;
#pragma unroll
    for (int j = 0; j < F::WPT; ++j) sum[r] += field_sum<BITS>(wd[r][j]);
  }
  uint32_t before[R];
  const uint32_t tile_total = block_scan_runs<R>(sum, before);
  const uint32_t base = tiles_before<uint32_t>(scratch, tile, tile_total);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long g = tile * F::TILE + r * F::SUB + (long long)threadIdx.x * F::VPT;
    const long long gw = g - (long long)lane * F::VPT;
    uint32_t run = base + before[r];
    if (gw + 32 * F::VPT <= n) {  // each output vector goes to the stage as it is made
#pragma unroll
      for (int v = 0; v < F::OUT_V; ++v)
        st[stage_slot(lane * F::OUT_V + v)] = scan_vector<T, BITS>(wd[r], v, &run);
      __syncwarp();
      uint4* dst = reinterpret_cast<uint4*>(out + gw);
#pragma unroll
      for (int k = 0; k < F::OUT_V; ++k)
        __stcs(dst + 32 * k + lane, st[stage_slot(32 * k + lane)]);
      __syncwarp();
    } else {
#pragma unroll
      for (int i = 0; i < F::VPT; ++i) {
        run += (wd[r][i / F::PER] >> (BITS * (i % F::PER))) & Packing<BITS>::MASK;
        if (g + i < n) out[g + i] = (T)run;
      }
    }
  }
}

template <typename T, int BITS>
static long long decode_tiles(long long n) {
  return (n + FDecode<T, BITS>::TILE - 1) / FDecode<T, BITS>::TILE;
}

template <typename T, int BITS>
static int launch_decode(const void* words, void* out, void* scratch, long long n_scratch,
                         long long n, cudaStream_t stream) {
  const long long m = (n + Packing<BITS>::PER - 1) / Packing<BITS>::PER;
  const long long tiles = decode_tiles<T, BITS>(n);
  const long long bytes = scan_scratch_bytes<uint32_t>(tiles);
  if (tiles < 1 || tiles > 0x7FFFFFFFLL || n_scratch < bytes || (uintptr_t)words % 4 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)bytes, stream);
  if (err != cudaSuccess) return (int)err;
  if ((uintptr_t)words % 16 == 0)
    fdb_decode_kernel<T, BITS, false><<<(unsigned int)tiles, FTHREADS, 0, stream>>>(
        (const uint32_t*)words, (T*)out, n, m, (unsigned char*)scratch);
  else
    fdb_decode_kernel<T, BITS, true><<<(unsigned int)tiles, FTHREADS, 0, stream>>>(
        (const uint32_t*)words, (T*)out, n, m, (unsigned char*)scratch);
  return (int)cudaGetLastError();
}

template <typename T, int BITS>
static long long decode_tile(long long) { return FDecode<T, BITS>::TILE; }

template <typename T, int BITS>
static long long decode_scratch(long long n) {
  return scan_scratch_bytes<uint32_t>(decode_tiles<T, BITS>(n));
}

// x: n values of `width` bytes -> out: ceil(n * bits / 32) words.
REPRO_API int repro_fused_delta_bitpack(const void* x, void* out, long long n, int width,
                                        int bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_WIDTH_BITS_SWITCH(launch_encode, width, bits, x, out, n, s)
}

// The scratch bytes that repro_fused_delta_bitpack_decode needs for n values
// at `bits` to `width` bytes (-1 for a pair outside the choices); the tile
// size lives here alone, and the wrapper asks for the size.
REPRO_API long long repro_fused_delta_bitpack_decode_scratch(long long n, int width, int bits) {
  REPRO_WIDTH_BITS_SWITCH_TO(decode_scratch, -1, width, bits, n)
}

// The values of one K12 tile at `bits` to `width` bytes (-1 outside the choices).
REPRO_API long long repro_fused_delta_bitpack_decode_tile(int width, int bits) {
  REPRO_WIDTH_BITS_SWITCH_TO(decode_tile, -1, width, bits, 0)
}

// words: at least ceil(n * bits / 32) words, 4-byte aligned -> out: n values
// of `width` bytes, 16-byte aligned (a fresh allocation).
REPRO_API int repro_fused_delta_bitpack_decode(const void* words, void* out, void* scratch,
                                               long long n_scratch, long long n, int width,
                                               int bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  REPRO_WIDTH_BITS_SWITCH(launch_decode, width, bits, words, out, scratch, n_scratch, n, s)
}
