// K1 — delta encode: out[0] = x[0], out[i] = x[i] - x[i-1] (wrapping, unsigned).
//
// Replaces the TPU kernel src/repro/kernels/delta.py, delta_encode_pallas
// (_encode_kernel), which walked 2048-element blocks in order and read the
// previous block's last element through a second block spec.
//
// Bound: bytes.  The function reads n*w bytes and writes n*w bytes and does
// one subtraction per element.  Design: one thread per element reads its own
// predecessor, so no block carry exists and blocks run in any order; the
// x[i-1] load hits the line its neighbour thread just fetched, so the kernel
// moves each byte once from device memory.  Templated on the element type so
// widths 1, 2, 4 and 8 (an int64 timestamp column) all run here, and the
// unsigned arithmetic wraps exactly as the wire codec's numpy subtraction.
#include "common.cuh"

template <typename T>
__global__ void delta_encode_kernel(const T* __restrict__ x, T* __restrict__ out,
                                    long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    T prev = i ? x[i - 1] : T(0);
    out[i] = (T)(x[i] - prev);
  }
}

template <typename T>
static int launch(const void* x, void* out, long long n, cudaStream_t stream) {
  const int threads = 256;
  delta_encode_kernel<T><<<repro_grid(n, threads, 1LL << 20), threads, 0, stream>>>(
      (const T*)x, (T*)out, n);
  return (int)cudaGetLastError();
}

REPRO_API int repro_delta_encode(const void* x, void* out, long long n, int width,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1: return launch<uint8_t>(x, out, n, s);
    case 2: return launch<uint16_t>(x, out, n, s);
    case 4: return launch<uint32_t>(x, out, n, s);
    case 8: return launch<unsigned long long>(x, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
