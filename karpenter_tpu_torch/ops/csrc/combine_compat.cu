// K1 combine_compat: the template x group head of the provisioning
// feasibility precompute.
//
// Replaces the first part of karpenter_tpu/ops/binpack.py precompute_kernel
// (lines 170-175): compatible_matrix(template, group, allow_undefined)
// (feasibility.py:89-98, over _pairwise_nonempty :64-77) and
// combine(template[:, None], group[None, :]) (:101-117), flattened m-major
// to [M*G, ...].
//
// Bound: bytes. M*G is small (120 at 50k pods x 2k types); the kernel reads
// M+G requirement rows and writes M*G combined rows, a few hundred KB, so
// what the card pays is the launch and one round trip to memory.
//
// Design: a pair's K*W mask words are contiguous in the template row, the
// group row and the combined row, so the words of a key are spread over a
// group of `lanes` lanes of one warp (a power of two, aligned in the warp),
// each lane moving `V` words at a time: 16-byte loads and stores (V = 4)
// when every row starts 16-byte aligned, single words (V = 1) otherwise.
// The group's first lane is the key's thread: it loads the key's flags and
// bounds (every load of a round is issued before any result is used),
// decides the joint Gt/Lt collapse and hands it to its lanes by a shuffle;
// the lanes AND, store and OR their words, and an xor-shuffle tree ORs the
// key's "nonempty" bit back together in the warp (a key of more than 32
// units keeps one warp and loops). No shared memory and no barrier until
// __syncthreads_or folds the keys' verdicts into compat_tm[m, g]. A block
// takes one pair (m, g); ops/kernels.py combine_plan picks V, lanes and the
// block size from K and W.
#include "feasibility_common.cuh"

#define KT_FULL_WARP 0xffffffffu

// V mask words moved as one unit: one 16-byte vector or one word.
template <int V>
struct KtUnit {
  uint32_t w[V];
};

template <int V>
__device__ __forceinline__ KtUnit<V> kt_load_unit(const uint32_t* p) {
  KtUnit<V> u;
  if constexpr (V == 4) {
    const uint4 v = __ldg((const uint4*)p);
    u.w[0] = v.x, u.w[1] = v.y, u.w[2] = v.z, u.w[3] = v.w;
  } else {
    u.w[0] = __ldg(p);
  }
  return u;
}

// Stores the unit `a & b`, or zeros for a crossed key; returns the OR of
// the stored words.
template <int V>
__device__ __forceinline__ uint32_t kt_and_store(uint32_t* p,
                                                 const KtUnit<V>& a,
                                                 const KtUnit<V>& b,
                                                 bool crossed) {
  KtUnit<V> x;
  uint32_t any = 0u;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    x.w[i] = crossed ? 0u : (a.w[i] & b.w[i]);
    any |= x.w[i];
  }
  if constexpr (V == 4) {
    *(uint4*)p = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
  } else {
    *p = x.w[0];
  }
  return any;
}

template <int V>
__global__ void combine_compat_kernel(
    const uint32_t* __restrict__ t_mask, const unsigned char* __restrict__ t_def,
    const unsigned char* __restrict__ t_comp, const unsigned char* __restrict__ t_ex,
    const int32_t* __restrict__ t_gt, const int32_t* __restrict__ t_lt,
    const uint32_t* __restrict__ g_mask, const unsigned char* __restrict__ g_def,
    const unsigned char* __restrict__ g_comp, const unsigned char* __restrict__ g_ex,
    const int32_t* __restrict__ g_gt, const int32_t* __restrict__ g_lt,
    const unsigned char* __restrict__ allow_undefined,
    int G, int K, int W, int lanes,
    uint32_t* __restrict__ c_mask, unsigned char* __restrict__ c_def,
    unsigned char* __restrict__ c_comp, unsigned char* __restrict__ c_ex,
    int32_t* __restrict__ c_gt, int32_t* __restrict__ c_lt,
    unsigned char* __restrict__ compat_tm) {
  const int m = blockIdx.y;
  const int g = blockIdx.x;
  const int units = W / V;  // V = 4 only when W % 4 == 0
  const int per_lane = (units + lanes - 1) / lanes;
  const int slots = blockDim.x / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int slot = threadIdx.x / lanes;
  const int leader = (threadIdx.x & 31) & ~(lanes - 1);  // in the warp
  const size_t row = (size_t)K * W;
  const uint32_t* trow = t_mask + (size_t)m * row;
  const uint32_t* grow = g_mask + (size_t)g * row;
  uint32_t* crow = c_mask + ((size_t)m * G + g) * row;
  const size_t tk0 = (size_t)m * K;
  const size_t gk0 = (size_t)g * K;
  const size_t ck0 = ((size_t)m * G + g) * K;

  bool bad = false;
  for (int k0 = 0; k0 < K; k0 += slots) {
    const int k = k0 + slot;
    const bool key = k < K;
    const bool first = key && lane == 0;
    // 1. every load of the round: the key's flags and bounds on its first
    // lane, the first unit of every lane
    int32_t tgt = 0, tlt = 0, ggt = 0, glt = 0;
    bool tdef = false, tcomp = false, tex = false, allow = false;
    bool gdef = false, gcomp = false, gex = false;
    if (first) {
      tgt = t_gt[tk0 + k];
      tlt = t_lt[tk0 + k];
      tdef = t_def[tk0 + k] != 0;
      tcomp = t_comp[tk0 + k] != 0;
      tex = t_ex[tk0 + k] != 0;
      allow = allow_undefined[k] != 0;
      ggt = g_gt[gk0 + k];
      glt = g_lt[gk0 + k];
      gdef = g_def[gk0 + k] != 0;
      gcomp = g_comp[gk0 + k] != 0;
      gex = g_ex[gk0 + k] != 0;
    }
    const size_t kw = (size_t)k * W;
    KtUnit<V> a{}, b{};
    if (key && lane < units) {
      a = kt_load_unit<V>(trow + kw + lane * V);
      b = kt_load_unit<V>(grow + kw + lane * V);
    }
    // 2. the joint Gt/Lt collapse, from the key's first lane
    const int32_t gt = max(tgt, ggt);
    const int32_t lt = min(tlt, glt);
    const bool crossed =
        __shfl_sync(KT_FULL_WARP, (int)kt_crossed(gt, lt), leader) != 0;
    // 3. AND, store and OR the key's words, then OR over the key's lanes
    uint32_t any = 0u;
    for (int j = 0; j < per_lane; ++j) {
      const int u = lane + j * lanes;
      if (key && u < units) {
        const size_t w = kw + (size_t)u * V;
        if (j) {
          a = kt_load_unit<V>(trow + w);
          b = kt_load_unit<V>(grow + w);
        }
        any |= kt_and_store<V>(crow + w, a, b, crossed);
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1)
      any |= __shfl_xor_sync(KT_FULL_WARP, any, o);
    // 4. the key's combined flags and bounds, and its verdict
    if (first) {
      const size_t ck = ck0 + k;
      // the combined mask is empty exactly when the pairwise intersection
      // is (a crossed key zeroes it), so one OR serves combine and compat
      const bool nonempty = any != 0u;
      const bool comp = tcomp && gcomp && !crossed;
      c_def[ck] = tdef || gdef;
      c_comp[ck] = comp;
      c_ex[ck] = comp ? (tex || gex) : !nonempty;
      // concrete results drop bounds (requirement.go:183-186)
      c_gt[ck] = comp ? gt : KT_INT_MIN;
      c_lt[ck] = comp ? lt : KT_INT_MAX;
      bad |= (tdef && gdef && !nonempty && !(tex && gex)) ||
             (gdef && !tdef && !allow && !gex);
    }
  }
  const int any_bad = __syncthreads_or(bad);
  // [M, G]: m * G + g
  if (threadIdx.x == 0) compat_tm[(size_t)m * G + g] = !any_bad;
}

template <int V>
static cudaError_t kt_launch_combine(
    dim3 grid, int threads, cudaStream_t stream, const void* t_mask,
    const void* t_def, const void* t_comp, const void* t_ex, const void* t_gt,
    const void* t_lt, const void* g_mask, const void* g_def,
    const void* g_comp, const void* g_ex, const void* g_gt, const void* g_lt,
    const void* allow_undefined, int G, int K, int W, int lanes, void* c_mask,
    void* c_def, void* c_comp, void* c_ex, void* c_gt, void* c_lt,
    void* compat_tm) {
  combine_compat_kernel<V><<<grid, threads, 0, stream>>>(
      (const uint32_t*)t_mask, (const unsigned char*)t_def,
      (const unsigned char*)t_comp, (const unsigned char*)t_ex,
      (const int32_t*)t_gt, (const int32_t*)t_lt,
      (const uint32_t*)g_mask, (const unsigned char*)g_def,
      (const unsigned char*)g_comp, (const unsigned char*)g_ex,
      (const int32_t*)g_gt, (const int32_t*)g_lt,
      (const unsigned char*)allow_undefined, G, K, W, lanes,
      (uint32_t*)c_mask, (unsigned char*)c_def, (unsigned char*)c_comp,
      (unsigned char*)c_ex, (int32_t*)c_gt, (int32_t*)c_lt,
      (unsigned char*)compat_tm);
  return cudaGetLastError();
}

// The plan (vec, lanes, threads) comes from ops/kernels.py combine_plan; a
// plan the kernel is not built for, or that breaks its thread mapping, is
// refused with cudaErrorInvalidValue.
extern "C" int kt_combine_compat(
    const void* t_mask, const void* t_def, const void* t_comp, const void* t_ex,
    const void* t_gt, const void* t_lt,
    const void* g_mask, const void* g_def, const void* g_comp, const void* g_ex,
    const void* g_gt, const void* g_lt, const void* allow_undefined,
    int M, int G, int K, int W, int vec, int lanes, int threads,
    void* c_mask, void* c_def, void* c_comp, void* c_ex, void* c_gt,
    void* c_lt, void* compat_tm, void* stream) {
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (!lanes_ok || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      (vec == 4 && W % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)G, (unsigned)M);
  const cudaStream_t s = (cudaStream_t)stream;
#define KT_COMBINE(V)                                                        \
  kt_launch_combine<V>(grid, threads, s, t_mask, t_def, t_comp, t_ex, t_gt,  \
                       t_lt, g_mask, g_def, g_comp, g_ex, g_gt, g_lt,        \
                       allow_undefined, G, K, W, lanes, c_mask, c_def,       \
                       c_comp, c_ex, c_gt, c_lt, compat_tm)
  cudaError_t err = cudaErrorInvalidValue;
  if (vec == 4) err = KT_COMBINE(4);
  else if (vec == 1) err = KT_COMBINE(1);
#undef KT_COMBINE
  return (int)err;
}

// The message of an error code any launcher of the library returned.
extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
