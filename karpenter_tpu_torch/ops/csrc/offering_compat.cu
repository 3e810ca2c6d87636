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
// key; never read) and otherwise kt_bit_fill: bit v of the row, and true for
// a value index at or past 32 * W — the reference gathers with
// jnp.take_along_axis, whose out-of-range fill for uint32 is all ones. No
// word past W is read.
//
// Bound: operations, narrowly. At B = 120 rows, T = 2,000 types and O = 8
// offerings the test is at most B * T * O = 1.9M offering checks of about
// ten integer operations each, over 0.06 MB of zone and capacity-type mask
// words, 0.14 MB of offerings and 0.24 MB of output bytes: under a
// microsecond either way, so the launch and one round trip are what the
// card pays.
//
// Design: a block of OC_THREADS threads takes a tile of OC_THREADS types
// and `rows` rows (the launcher's OC_ROWS, halved while the staging would
// not fit): 480 blocks at B = 120, T = 2,000, about 3.6 an SM, so that
// each scheduler has warps to switch between (tiles of 1, 2, 8 and 16 rows
// measured slower on the card). One group of asynchronous
// copies stages the tile's offerings (zone, capacity type, availability:
// contiguous in [T, O]) and the rows' zone and capacity-type mask words in
// shared memory, 16 bytes a copy where source and destination allow.
// Thread t then reads type t's offerings into registers, OC_CHUNK at a time
// (16-byte shared loads when O % 4 == 0: a type's offerings are 32 bytes
// apart at O = 8, so word loads would meet eight to a bank), and tests
// every row of the tile against all of them: the rows unrolled, no early
// exit, and an unconstrained offering read at index 0 and admitted by the
// OR, so every mask word a row needs is one independent shared load. The
// byte stores come last, coalesced along t. Index arithmetic is 32-bit:
// the wrapper refuses tensors of 2^31 elements or more.
#include "feasibility_common.cuh"

#define OC_THREADS 128  // = KT_JOIN_THREADS: the copy helpers' stride
#define OC_ROWS 4
#define OC_CHUNK 8

// Byte offsets of the staged tile in dynamic shared memory.
struct OcLayout {
  int zone, captype, zrows, crows, avail, total;
};

__host__ __device__ inline OcLayout oc_layout(int rows, int W, int O) {
  OcLayout l;
  const int offers = OC_THREADS * O * 4;
  const int words = rows * W * 4;
  l.zone = 0;
  l.captype = (int)kt_align(offers);
  l.zrows = l.captype + (int)kt_align(offers);
  l.crows = l.zrows + (int)kt_align(words);
  l.avail = l.crows + (int)kt_align(words);
  l.total = l.avail + (int)kt_align(OC_THREADS * O);
  return l;
}

// n words from global `src` to shared `dst`: 16-byte copies when both ends
// are 16-byte aligned, else one word a copy.
__device__ __forceinline__ void oc_copy_words(uint32_t* dst,
                                              const uint32_t* src, int n) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if ((uintptr_t)src % 16 == 0 && d % 16 == 0) {
    const int v = n / 4;
    for (int i = threadIdx.x; i < v; i += OC_THREADS)
      kt_cp_async16(d + 16 * i, src + 4 * i);
    for (int i = 4 * v + threadIdx.x; i < n; i += OC_THREADS)
      kt_cp_async4(d + 4 * i, src + i);
  } else {
    kt_copy_words(dst, src, n);
  }
}

// One key's W words of `nb` rows from row b0 (rows K * W words apart) to
// shared `dst` (rows W words apart).
__device__ __forceinline__ void oc_copy_rows(uint32_t* dst,
                                             const uint32_t* mask, int b0,
                                             int nb, int K, int W, int key) {
  const uint32_t* src = mask + (b0 * K + key) * W;
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const bool vec = W % 4 == 0 && (uintptr_t)src % 16 == 0 && d % 16 == 0;
  const int per = vec ? W / 4 : W;  // copies a row
  for (int i = threadIdx.x; i < nb * per; i += OC_THREADS) {
    const int r = i / per, c = i - r * per;
    if (vec)
      kt_cp_async16(d + 4 * (r * W + 4 * c), src + r * K * W + 4 * c);
    else
      kt_cp_async4(d + 4 * (r * W + c), src + r * K * W + c);
  }
}

__global__ void offering_compat_kernel(
    const uint32_t* __restrict__ mask_b, const int32_t* __restrict__ off_zone,
    const int32_t* __restrict__ off_captype,
    const unsigned char* __restrict__ off_avail, int B, int T, int K, int W,
    int O, int zone_key, int captype_key, int rows,
    unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const OcLayout L = oc_layout(rows, W, O);
  const int t0 = blockIdx.x * OC_THREADS, b0 = blockIdx.y * rows;
  const int nt = min(OC_THREADS, T - t0), nb = min(rows, B - b0);
  int32_t* s_zone = (int32_t*)(smem + L.zone);
  int32_t* s_cap = (int32_t*)(smem + L.captype);
  const uint32_t* s_zrows = (const uint32_t*)(smem + L.zrows);
  const uint32_t* s_crows = (const uint32_t*)(smem + L.crows);
  unsigned char* s_avail = smem + L.avail;

  oc_copy_words((uint32_t*)s_zone, (const uint32_t*)off_zone + t0 * O,
                nt * O);
  oc_copy_words((uint32_t*)s_cap, (const uint32_t*)off_captype + t0 * O,
                nt * O);
  oc_copy_rows((uint32_t*)s_zrows, mask_b, b0, nb, K, W, zone_key);
  oc_copy_rows((uint32_t*)s_crows, mask_b, b0, nb, K, W, captype_key);
  kt_copy_bytes(s_avail, 0, off_avail + t0 * O, 0, 1, nt * O);
  kt_cp_commit();
  kt_cp_wait<0>();
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= nt) return;  // no barrier follows
  bool hit[OC_ROWS] = {};
  for (int o0 = 0; o0 < O; o0 += OC_CHUNK) {
    // type t's offerings o0 .. o0 + OC_CHUNK - 1; those past O unavailable
    int32_t zone[OC_CHUNK], cap[OC_CHUNK];
    bool avail[OC_CHUNK];
    if (O % 4 == 0) {
#pragma unroll
      for (int j = 0; j < OC_CHUNK; j += 4) {
        const int i = t * O + o0 + j;
        const bool in = o0 + j < O;  // then so are the next three
        const int4 z = in ? *(const int4*)(s_zone + i) : make_int4(0, 0, 0, 0);
        const int4 c = in ? *(const int4*)(s_cap + i) : make_int4(0, 0, 0, 0);
        const uint32_t av = in ? *(const uint32_t*)(s_avail + i) : 0u;
        zone[j] = z.x, zone[j + 1] = z.y, zone[j + 2] = z.z, zone[j + 3] = z.w;
        cap[j] = c.x, cap[j + 1] = c.y, cap[j + 2] = c.z, cap[j + 3] = c.w;
#pragma unroll
        for (int q = 0; q < 4; ++q) avail[j + q] = (av >> (8 * q)) & 0xffu;
      }
    } else {
#pragma unroll
      for (int j = 0; j < OC_CHUNK; ++j) {
        const int i = t * O + o0 + j;
        const bool in = o0 + j < O;
        zone[j] = in ? s_zone[i] : 0;
        cap[j] = in ? s_cap[i] : 0;
        avail[j] = in && s_avail[i] != 0;
      }
    }
#pragma unroll
    for (int b = 0; b < OC_ROWS; ++b) {
      // rows past the tile repeat its last row; their verdicts are dropped
      const int r = min(b, nb - 1);
      const uint32_t* zrow = s_zrows + r * W;
      const uint32_t* crow = s_crows + r * W;
      bool ok = false;
#pragma unroll
      for (int j = 0; j < OC_CHUNK; ++j)
        ok |= avail[j] &
              ((zone[j] < 0) | kt_bit_fill(zrow, max(zone[j], 0), W)) &
              ((cap[j] < 0) | kt_bit_fill(crow, max(cap[j], 0), W));
      hit[b] |= ok;
    }
  }
#pragma unroll
  for (int b = 0; b < OC_ROWS; ++b)
    if (b < nb) out[(b0 + b) * T + t0 + t] = hit[b];
}

extern "C" int kt_offering_compat(const void* mask_b, const void* off_zone,
                                  const void* off_captype,
                                  const void* off_avail, int B, int T, int K,
                                  int W, int O, int zone_key, int captype_key,
                                  void* out, void* stream) {
  int rows = OC_ROWS;
  while (rows > 1 && (size_t)oc_layout(rows, W, O).total > 227 * 1024)
    rows /= 2;
  const size_t smem = oc_layout(rows, W, O).total;
  cudaError_t err = kt_allow_smem(offering_compat_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + OC_THREADS - 1) / OC_THREADS),
                  (unsigned)((B + rows - 1) / rows));
  offering_compat_kernel<<<grid, OC_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)mask_b, (const int32_t*)off_zone,
      (const int32_t*)off_captype, (const unsigned char*)off_avail, B, T, K, W,
      O, zone_key, captype_key, rows, (unsigned char*)out);
  return (int)cudaGetLastError();
}
