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
// ANDs over 18.9 MB of node masks.
//
// Design: as catalog_feasibility, a block of 128 threads covers 128
// consecutive nodes for a tile of up to KT_TILE_MAX groups held in shared
// memory; each node mask word is read once per tile. Stores are [G, N] with
// the node index fastest, so they coalesce.
#include "feasibility_common.cuh"

__global__ void exist_feasibility_kernel(
    const uint32_t* __restrict__ g_mask, const unsigned char* __restrict__ g_def,
    const unsigned char* __restrict__ g_ex, const int32_t* __restrict__ g_gt,
    const int32_t* __restrict__ g_lt, const int32_t* __restrict__ group_req,
    const uint32_t* __restrict__ e_mask, const unsigned char* __restrict__ e_def,
    const unsigned char* __restrict__ e_ex, const int32_t* __restrict__ e_gt,
    const int32_t* __restrict__ e_lt, const int32_t* __restrict__ exist_avail,
    const unsigned char* __restrict__ tol_exist,
    int G, int N, int K, int W, int R, int tile,
    unsigned char* __restrict__ exist_ok, int32_t* __restrict__ exist_cap) {
  extern __shared__ uint32_t s_grp[];  // [tile, K, W]
  const int g0 = blockIdx.y * tile;
  const int nt = min(tile, G - g0);
  const size_t row_words = (size_t)K * W;
  for (size_t i = threadIdx.x; i < (size_t)nt * row_words; i += blockDim.x)
    s_grp[i] = g_mask[(size_t)g0 * row_words + i];
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  bool bad[KT_TILE_MAX];
#pragma unroll
  for (int j = 0; j < KT_TILE_MAX; ++j) bad[j] = false;
  uint32_t acc[KT_TILE_MAX];
  for (int k = 0; k < K; ++k) {
    const size_t nk = (size_t)n * K + k;
    kt_and_words(e_mask + nk * W, s_grp, nt, k, K, W, acc);
    const bool edef = e_def[nk] != 0, eex = e_ex[nk] != 0;
    const int32_t egt = e_gt[nk], elt = e_lt[nk];
#pragma unroll
    for (int j = 0; j < KT_TILE_MAX; ++j) {
      if (j >= nt) break;
      const size_t gk = (size_t)(g0 + j) * K + k;
      const bool gdef = g_def[gk] != 0, gex = g_ex[gk] != 0;
      const bool nonempty =
          acc[j] != 0u && !kt_crossed(max(egt, g_gt[gk]), min(elt, g_lt[gk]));
      bad[j] |= (edef && gdef && !nonempty && !(eex && gex)) ||
                (gdef && !edef && !gex);
    }
  }

#pragma unroll
  for (int j = 0; j < KT_TILE_MAX; ++j) {
    if (j >= nt) break;
    const int g = g0 + j;
    int32_t per = KT_INT_MAX;
    for (int r = 0; r < R; ++r) {
      const int32_t req = group_req[(size_t)g * R + r];
      if (req > 0)
        per = min(per, kt_floordiv(exist_avail[(size_t)n * R + r], req));
    }
    const int32_t cap = max(per, 0);
    const size_t out = (size_t)g * N + n;
    exist_cap[out] = cap;
    exist_ok[out] = !bad[j] && tol_exist[out] != 0 && cap >= 1;
  }
}

extern "C" int kt_exist_feasibility(
    const void* g_mask, const void* g_def, const void* g_ex, const void* g_gt,
    const void* g_lt, const void* group_req,
    const void* e_mask, const void* e_def, const void* e_ex, const void* e_gt,
    const void* e_lt, const void* exist_avail, const void* tol_exist,
    int G, int N, int K, int W, int R,
    void* exist_ok, void* exist_cap, void* stream) {
  const int tile = kt_tile(K, W, G);
  const size_t smem = (size_t)tile * K * W * sizeof(uint32_t);
  cudaError_t err = kt_allow_smem(exist_feasibility_kernel, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return (int)err;
  }
  const int threads = 128;
  dim3 grid((N + threads - 1) / threads, (G + tile - 1) / tile);
  exist_feasibility_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)g_mask, (const unsigned char*)g_def,
      (const unsigned char*)g_ex, (const int32_t*)g_gt, (const int32_t*)g_lt,
      (const int32_t*)group_req,
      (const uint32_t*)e_mask, (const unsigned char*)e_def,
      (const unsigned char*)e_ex, (const int32_t*)e_gt, (const int32_t*)e_lt,
      (const int32_t*)exist_avail, (const unsigned char*)tol_exist,
      G, N, K, W, R, tile, (unsigned char*)exist_ok, (int32_t*)exist_cap);
  return (int)cudaGetLastError();
}
