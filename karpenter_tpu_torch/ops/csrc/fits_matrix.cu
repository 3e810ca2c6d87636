// B5a fits_matrix: the resource fit of request rows against available rows.
//
// Replaces karpenter_tpu/ops/feasibility.py fits_matrix (lines 120-126):
//   fits[a, b] = all over r of (req[b, r] <= 0 || req[b, r] <= avail[a, r])
// on int32, exactly: a zero or negative request always fits
// (resources.Fits), and there is no float path.
//
// Bound: operations, narrowly. At B = 120 request rows, A = 8,192 node rows
// and R = 4 the test is A * B * R = 3.9M (compare, compare, OR, AND) groups
// over 0.13 MB of inputs and 0.98 MB of output bytes; both bounds are under
// a microsecond, so a launch (a few microseconds) is what the card pays.
//
// Design: one thread per (a, b), b fastest, so the byte stores of a warp
// coalesce and the warp's 32 request rows come from one or two cache lines
// while its avail row is one broadcast read. The R loop runs in registers;
// R is a runtime argument.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void fits_matrix_kernel(const int32_t* __restrict__ req,
                                   const int32_t* __restrict__ avail,
                                   int A, int B, int R,
                                   unsigned char* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)A * B) return;
  const size_t a = i / B, b = i % B;
  const int32_t* rq = req + b * R;
  const int32_t* av = avail + a * R;
  bool fits = true;
  for (int r = 0; r < R; ++r) {
    const int32_t q = __ldg(rq + r);
    fits = fits && (q <= 0 || q <= __ldg(av + r));
  }
  out[i] = fits;
}

extern "C" int kt_fits_matrix(const void* req, const void* avail, int A, int B,
                              int R, void* out, void* stream) {
  const int threads = 256;
  const size_t n = (size_t)A * B;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  fits_matrix_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)req, (const int32_t*)avail, A, B, R,
      (unsigned char*)out);
  return (int)cudaGetLastError();
}
