// K3 exist_feasibility: pod groups against existing nodes.
//
// Replaces karpenter_tpu/ops/binpack.py _exist_delta_kernel (lines 616-632)
// and the identical has_exist branch of precompute_kernel (lines 221-232):
// both of the port's entry points launch this one kernel, so the two cannot
// drift. Per (g, n):
//   exist_ok  = compatible_matrix(exist, group, no allow-undefined)[n, g]
//               & tol_exist[g, n] & exist_cap >= 1
//   exist_cap = clip(min over r of (req > 0 ? avail // req : INT32_MAX),
//                    0, INT32_MAX)
// avail may be negative (available minus daemon overhead), so `//` is a
// floor division here, and the clip comes after the minimum.
//
// Bound: operations. At 5,000 nodes (N = 8192 after the pow2 bucket) and
// G = 120, K = 9, W = 64 the compatibility test is G * N * K * W = 566M word
// ANDs (one LOP3 each) over 18.9 MB of node masks; the card's 32-bit logic
// rate bounds it, not its memory.
//
// Design: the mask join of feasibility_common.cuh with nodes on the A side
// and groups on the B side. The node-major [N, K, W] rows stay as they are
// (row_splice and the mesh shards write them); a block copies one key's
// rows of its node tile and group tile at a time into a double-buffered
// shared-memory ring with coalesced cp.async chunks, and each thread ANDs an
// RA x RB register tile of pairs from 16-byte shared loads, so the integer
// pipe, not the loads, sets the pace. The tile sizes come from
// ops/kernels.py join_plan: at the north-star shape 128 nodes x 32 groups
// (256 blocks, two to an SM, each node mask word read by 4 blocks); at the
// disruption shape (G = 8, W = 8) 32 nodes x 8 groups (256 blocks) with
// every key copied at once. The block's avail, requests and tol_exist
// arrive with its first copies; the division by each request is a multiply
// by its reciprocal (kt_floordiv), done for all the thread's pairs one
// resource at a time. Stores are [G, N] with the node index fastest.
#include "feasibility_common.cuh"

template <int RA, int RB>
__global__ void __launch_bounds__(KT_JOIN_THREADS) exist_feasibility_kernel(
    KtSide exist, KtSide group, const int32_t* __restrict__ group_req,
    const int32_t* __restrict__ exist_avail,
    const unsigned char* __restrict__ tol_exist, int K, int W, int R,
    int stages, bool vec, unsigned char* __restrict__ exist_ok,
    int32_t* __restrict__ exist_cap) {
  constexpr int TA = KT_JOIN_TX * RA, TB = KT_JOIN_TY * RB;
  extern __shared__ __align__(16) unsigned char smem[];
  const KtJoinLayout L = kt_join_layout(TA, TB, K, W, stages);
  double* s_rcp = (double*)(smem + L.extra);              // [TB, R]: 1 / req
  int32_t* s_avail = (int32_t*)(s_rcp + (size_t)TB * R);  // [TA, R]
  int32_t* s_req = s_avail + (size_t)TA * R;              // [TB, R]
  unsigned char* s_tol = (unsigned char*)(s_req + (size_t)TB * R);  // [TB, TA]
  const int N = exist.rows, G = group.rows;
  const int n0 = blockIdx.x * TA, g0 = blockIdx.y * TB;
  const int nn = max(0, min(TA, N - n0)), ng = max(0, min(TB, G - g0));

  const uint32_t bad = kt_join<RA, RB>(
      exist, group, K, W, stages, vec, smem, KtCompatiblePred(),
      [&] {
        kt_copy_words(s_avail, exist_avail + (size_t)n0 * R, nn * R);
        kt_copy_words(s_req, group_req + (size_t)g0 * R, ng * R);
        kt_copy_bytes(s_tol, TA, tol_exist + (size_t)g0 * N + n0, N, ng, nn);
      },
      [&] {
        for (int i = threadIdx.x; i < ng * R; i += KT_JOIN_THREADS)
          s_rcp[i] = s_req[i] > 0 ? 1.0 / s_req[i] : 0.0;
      });

  // exist_cap for the thread's pairs, resource by resource so that the
  // pairs' divisions are independent of each other
  const int ta = threadIdx.x % KT_JOIN_TX, tb = threadIdx.x / KT_JOIN_TX;
  int32_t per[RA][RB];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) per[i][j] = KT_INT_MAX;
  for (int r = 0; r < R; ++r) {
    int32_t avail[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i)
      avail[i] = s_avail[(ta + KT_JOIN_TX * i) * R + r];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int gl = tb + KT_JOIN_TY * j;
      const int32_t req = s_req[gl * R + r];
      const double rcp = s_rcp[gl * R + r];
      if (req > 0)
#pragma unroll
        for (int i = 0; i < RA; ++i)
          per[i][j] = min(per[i][j], kt_floordiv(avail[i], req, rcp));
    }
  }
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const int gl = tb + KT_JOIN_TY * j;
    if (gl >= ng) break;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int nl = ta + KT_JOIN_TX * i;
      if (nl >= nn) break;
      const int32_t cap = max(per[i][j], 0);
      const size_t out = (size_t)(g0 + gl) * N + n0 + nl;
      exist_cap[out] = cap;
      exist_ok[out] = !((bad >> (i * RB + j)) & 1u) &&
                      s_tol[gl * TA + nl] != 0 && cap >= 1;
    }
  }
}

// Dynamic shared memory of one block of a tile_a x tile_b tile (ops/kernels.py
// join_smem mirrors it).
extern "C" size_t kt_exist_feasibility_smem(int ta, int tb, int K, int W,
                                            int R, int stages) {
  return kt_join_layout(ta, tb, K, W, stages).extra +
         (size_t)tb * R * sizeof(double) +
         (size_t)(ta + tb) * R * sizeof(int32_t) + (size_t)tb * ta;
}

// The tiles the launches of chip_smoke.py's paths pick (its join_plans).
using ExistTiles =
    KtTiles<KtTile<8, 4>, KtTile<4, 2>, KtTile<2, 2>, KtTile<2, 1>,
            KtTile<1, 1>>;

// ra, rb, stages: the tile plan of ops/kernels.py join_plan.
extern "C" int kt_exist_feasibility(
    const void* g_mask, const void* g_def, const void* g_ex, const void* g_gt,
    const void* g_lt, const void* group_req,
    const void* e_mask, const void* e_def, const void* e_ex, const void* e_gt,
    const void* e_lt, const void* exist_avail, const void* tol_exist,
    int G, int N, int K, int W, int R, int ra, int rb, int stages,
    void* exist_ok, void* exist_cap, void* stream) {
  const KtSide group{(const uint32_t*)g_mask, (const unsigned char*)g_def,
                     (const unsigned char*)g_ex, (const int32_t*)g_gt,
                     (const int32_t*)g_lt, G};
  const KtSide exist{(const uint32_t*)e_mask, (const unsigned char*)e_def,
                     (const unsigned char*)e_ex, (const int32_t*)e_gt,
                     (const int32_t*)e_lt, N};
  const bool vec = W % 4 == 0 && ((uintptr_t)g_mask % 16) == 0 &&
                   ((uintptr_t)e_mask % 16) == 0;
  const cudaError_t err = ExistTiles::dispatch(ra, rb, [&](auto tile) {
    constexpr int RA = decltype(tile)::ra, RB = decltype(tile)::rb;
    constexpr int TA = KT_JOIN_TX * RA, TB = KT_JOIN_TY * RB;
    const size_t smem = kt_exist_feasibility_smem(TA, TB, K, W, R, stages);
    cudaError_t e = kt_allow_smem(exist_feasibility_kernel<RA, RB>, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((N + TA - 1) / TA, (G + TB - 1) / TB);
    exist_feasibility_kernel<RA, RB>
        <<<grid, KT_JOIN_THREADS, smem, (cudaStream_t)stream>>>(
            exist, group, (const int32_t*)group_req,
            (const int32_t*)exist_avail, (const unsigned char*)tol_exist, K, W,
            R, stages, vec, (unsigned char*)exist_ok, (int32_t*)exist_cap);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) cudaGetLastError();  // clear it for the next launch
  return (int)err;
}
