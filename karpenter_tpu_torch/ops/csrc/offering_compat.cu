// B5b offering_compat: does any available offering of each instance type
// satisfy each row's zone and capacity-type masks.
//
// Replaces karpenter_tpu/ops/feasibility.py offering_compat (lines
// 129-154) (Offerings.Available().HasCompatible):
//   out[b, t] = any over o of (off_available[t, o]
//                              && admits(mask_b[b, zone_key], off_zone[t, o])
//                              && admits(mask_b[b, captype_key],
//                                        off_captype[t, o]))
// admits(row, v) is true for v = -1 (the offering does not constrain the
// key; never read) and for a value index at or past 32 * W — the reference
// gathers with jnp.take_along_axis, whose out-of-range fill for uint32 is
// all ones — and otherwise is bit v of the row. No word past W is read.
//
// Bound: operations, narrowly. At B = 120 rows, T = 2,000 types and O = 8
// offerings the test is at most B * T * O = 1.9M offering checks of about
// ten integer operations each, over 0.06 MB of zone and capacity-type mask
// words, 0.14 MB of offerings and 0.24 MB of output bytes: under a
// microsecond either way, so the launch dominates.
//
// Design: one thread per (b, t), t fastest, so a warp's offering reads are
// contiguous and its byte stores coalesce; the warp shares its row's two
// mask keys through L1. The O loop runs in registers and stops at the first
// admitted offering. The uint32 mask words arrive as int32 bits and are
// read as uint32.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ bool oc_admits(const uint32_t* __restrict__ row,
                                          int W, int32_t v) {
  if (v < 0) return true;
  const int32_t word = v >> 5;
  if (word >= W) return true;
  return (__ldg(row + word) >> (v & 31)) & 1u;
}

__global__ void offering_compat_kernel(
    const uint32_t* __restrict__ mask_b, const int32_t* __restrict__ off_zone,
    const int32_t* __restrict__ off_captype,
    const unsigned char* __restrict__ off_avail, int B, int T, int K, int W,
    int O, int zone_key, int captype_key, unsigned char* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * T) return;
  const size_t b = i / T, t = i % T;
  const uint32_t* zrow = mask_b + (b * K + zone_key) * W;
  const uint32_t* crow = mask_b + (b * K + captype_key) * W;
  bool ok = false;
  for (int o = 0; o < O && !ok; ++o) {
    const size_t to = t * O + o;
    ok = off_avail[to] != 0 && oc_admits(zrow, W, __ldg(off_zone + to)) &&
         oc_admits(crow, W, __ldg(off_captype + to));
  }
  out[i] = ok;
}

extern "C" int kt_offering_compat(const void* mask_b, const void* off_zone,
                                  const void* off_captype,
                                  const void* off_avail, int B, int T, int K,
                                  int W, int O, int zone_key, int captype_key,
                                  void* out, void* stream) {
  const int threads = 256;
  const size_t n = (size_t)B * T;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  offering_compat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mask_b, (const int32_t*)off_zone,
      (const int32_t*)off_captype, (const unsigned char*)off_avail, B, T, K, W,
      O, zone_key, captype_key, (unsigned char*)out);
  return (int)cudaGetLastError();
}
