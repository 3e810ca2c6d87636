// B5a fits_matrix: the resource fit of request rows against available rows.
//
// Replaces karpenter_tpu/ops/feasibility.py fits_matrix (lines 120-126):
//   fits[a, b] = all over r of (req[b, r] <= 0 || req[b, r] <= avail[a, r])
// on int32, exactly: a zero or negative request always fits
// (resources.Fits), the comparison is signed, and there is no float path.
//
// Bound: bytes, narrowly. At B = 120 request rows, A = 8,192 node rows and
// R = 4 the test is A * B * R = 3.9M (compare, AND) pairs (the "request of
// zero or less" test depends on (b, r) alone and is made once a staged
// word) over 0.13 MB of inputs and 0.98 MB of output bytes; both bounds
// are under a microsecond, so the launch and one round trip to memory are
// what the card pays, and every instruction a thread spends past them shows.
//
// Design (the launcher's geometry is kernels.fits_plan):
// - a thread owns runs of `V` consecutive outputs of one avail row and
//   stores each run with one V-byte store (16, 8 or 4: the widest that
//   divides B, so that every row, which starts at byte a * B, stays aligned;
//   byte stores when none does). Consecutive threads take consecutive runs,
//   so a warp's stores cover one contiguous span;
// - a block stages its tile of request rows (all of B, or a tile of them
//   when B * R words would not fit in FM_SMEM_BYTES) in shared memory once,
//   each run's V * R words padded so that the runs the lanes of a quarter
//   warp read fall on different banks; a request of zero or less is staged
//   as INT_MIN, which is at most any avail, so the inner test is one signed
//   compare;
// - at R = 4 (and a 16-byte-aligned avail) a thread reads its avail row as
//   one int4, issued before the staging barrier so that the two round trips
//   overlap, and each request row as one int4 from shared memory; other
//   values of R loop over the resources at run time;
// - a block takes `rows` avail rows of one request tile, enough runs for
//   each thread to have one: 482 blocks of 256 threads at the shape above;
// - indices are 32-bit: the wrapper refuses inputs of 2^31 or more elements.
#include <cstdint>
#include <cuda_runtime.h>

#define FM_THREADS 256

// Shared-memory words from one run's requests to the next: its V * R words
// and a pad (4 words on the int4 path, to keep 16-byte alignment).
__host__ __device__ inline int fm_run_stride(int V, int R, bool vec4) {
  return V * R + (vec4 ? 4 : 1);
}

// Output bit j of a run (j < 4) as byte j of a word.
__device__ __forceinline__ uint32_t fm_bytes(uint32_t nibble) {
  return (nibble & 1u) | ((nibble & 2u) << 7) | ((nibble & 4u) << 14) |
         ((nibble & 8u) << 21);
}

// One run's V output bits (bit j: output j fits; no bit at or past V) as V
// bytes, in one store.
template <int V>
__device__ __forceinline__ void fm_store(unsigned char* p, uint32_t bits) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(fm_bytes(bits & 15u), fm_bytes((bits >> 4) & 15u),
                   fm_bytes((bits >> 8) & 15u), fm_bytes(bits >> 12));
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(fm_bytes(bits & 15u), fm_bytes(bits >> 4));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = fm_bytes(bits);
  } else {
    *p = (unsigned char)bits;
  }
}

template <int V, bool VEC4>
__global__ void __launch_bounds__(FM_THREADS)
fits_matrix_kernel(const int32_t* __restrict__ req,
                   const int32_t* __restrict__ avail, int A, int B, int R,
                   int tile_b, int rows, unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) int32_t sreq[];
  const int b0 = blockIdx.y * tile_b;
  const int runs = min(tile_b, B - b0) / V;  // V divides B and tile_b
  const int stride = fm_run_stride(V, R, VEC4);
  const int a0 = blockIdx.x * rows;
  const int items = min(rows, A - a0) * runs;

  // the avail row of this thread's first run, in flight during the staging
  const int4* avail4 = reinterpret_cast<const int4*>(avail);
  int4 av4 = make_int4(0, 0, 0, 0);
  if (VEC4 && threadIdx.x < items)
    av4 = __ldg(avail4 + a0 + threadIdx.x / runs);

  // stage the tile's requests: column col's words go to run col / V, slot
  // (col % V) * R; a request of zero or less (always fits) as INT_MIN
  const int32_t* src = req + b0 * R;
  for (int w = threadIdx.x; w < runs * V * R; w += FM_THREADS) {
    const int col = w / R;
    const int32_t q = __ldg(src + w);
    sreq[(col / V) * stride + (col % V) * R + (w - col * R)] =
        q <= 0 ? INT32_MIN : q;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < items; i += FM_THREADS) {
    const int al = i / runs, c = i - al * runs;
    const int a = a0 + al;
    const int32_t* s = sreq + c * stride;
    uint32_t bits = 0;  // bit j: output j of the run fits
    if constexpr (VEC4) {
      const int4 av = av4;
      // the next run's avail row, in flight during this one's tests
      if (i + FM_THREADS < items)
        av4 = __ldg(avail4 + a0 + (i + FM_THREADS) / runs);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int4 q = *reinterpret_cast<const int4*>(s + 4 * j);
        const bool fit = (q.x <= av.x) & (q.y <= av.y) & (q.z <= av.z) &
                         (q.w <= av.w);
        bits |= (uint32_t)fit << j;
      }
    } else {
      uint32_t miss = 0;  // bit j: output j of the run fails some resource
      for (int r = 0; r < R; ++r) {
        const int32_t av = __ldg(avail + a * R + r);
#pragma unroll
        for (int j = 0; j < V; ++j)
          miss |= (uint32_t)(s[j * R + r] > av) << j;
      }
      bits = ~miss & ((1u << V) - 1u);
    }
    fm_store<V>(out + a * B + b0 + c * V, bits);
  }
}

template <int V, int VEC4>
static cudaError_t fm_launch(const int32_t* req, const int32_t* avail, int A,
                             int B, int R, int tile_b, int rows,
                             unsigned char* out, cudaStream_t stream) {
  const dim3 grid((A + rows - 1) / rows, (B + tile_b - 1) / tile_b);
  const size_t smem =
      (size_t)(tile_b / V) * fm_run_stride(V, R, VEC4 != 0) * sizeof(int32_t);
  fits_matrix_kernel<V, VEC4 != 0><<<grid, FM_THREADS, smem, stream>>>(
      req, avail, A, B, R, tile_b, rows, out);
  return cudaGetLastError();
}

// width: V (16, 8, 4 or 1; it divides B and tile_b); vec4: R == 4 and avail
// 16-byte aligned; tile_b: request rows a block stages; rows: avail rows a
// block takes (kernels.fits_plan).
extern "C" int kt_fits_matrix(const void* req, const void* avail, int A, int B,
                              int R, int width, int vec4, int tile_b, int rows,
                              void* out, void* stream) {
  const int32_t* q = (const int32_t*)req;
  const int32_t* av = (const int32_t*)avail;
  unsigned char* o = (unsigned char*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4 && R != 4) return (int)cudaErrorInvalidValue;
#define FM_CASE(V, VEC4)     \
  case V * 2 + VEC4:         \
    return (int)fm_launch<V, VEC4>(q, av, A, B, R, tile_b, rows, o, s);
  switch (width * 2 + (vec4 ? 1 : 0)) {
    FM_CASE(16, 1) FM_CASE(16, 0) FM_CASE(8, 1) FM_CASE(8, 0)
    FM_CASE(4, 1) FM_CASE(4, 0) FM_CASE(1, 1) FM_CASE(1, 0)
    default: return (int)cudaErrorInvalidValue;
  }
}
