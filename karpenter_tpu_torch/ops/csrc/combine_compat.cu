// K1 combine_compat: the template x group head of the provisioning
// feasibility precompute.
//
// Replaces the first part of karpenter_tpu/ops/binpack.py precompute_kernel
// (lines 171-175): compatible_matrix(template, group, allow_undefined) and
// combine(template[:, None], group[None, :]) flattened m-major to [M*G, ...].
//
// Bound: bytes. M*G is small (120 at 50k pods x 2k types); the kernel reads
// M+G requirement rows and writes M*G combined rows, a few hundred KB, so it
// is launch-bound in practice. It exists so that no device math of the
// precompute runs outside a hand-written kernel.
//
// Design: one block of 32 threads per (m, g) pair; lane l handles keys
// l, l+32, ...: the combined key row, its flags and bounds, and the key's
// compatibility verdict. A warp vote reduces the verdicts over K into
// compat_tm[m, g].
#include "feasibility_common.cuh"

__global__ void combine_compat_kernel(
    const uint32_t* __restrict__ t_mask, const unsigned char* __restrict__ t_def,
    const unsigned char* __restrict__ t_comp, const unsigned char* __restrict__ t_ex,
    const int32_t* __restrict__ t_gt, const int32_t* __restrict__ t_lt,
    const uint32_t* __restrict__ g_mask, const unsigned char* __restrict__ g_def,
    const unsigned char* __restrict__ g_comp, const unsigned char* __restrict__ g_ex,
    const int32_t* __restrict__ g_gt, const int32_t* __restrict__ g_lt,
    const unsigned char* __restrict__ allow_undefined,
    int G, int K, int W,
    uint32_t* __restrict__ c_mask, unsigned char* __restrict__ c_def,
    unsigned char* __restrict__ c_comp, unsigned char* __restrict__ c_ex,
    int32_t* __restrict__ c_gt, int32_t* __restrict__ c_lt,
    unsigned char* __restrict__ compat_tm) {
  const int mg = blockIdx.x;
  const int m = mg / G;
  const int g = mg % G;
  bool bad = false;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const size_t tk = (size_t)m * K + k;
    const size_t gk = (size_t)g * K + k;
    const size_t ck = (size_t)mg * K + k;
    const int32_t gt = max(t_gt[tk], g_gt[gk]);
    const int32_t lt = min(t_lt[tk], g_lt[gk]);
    const bool crossed = kt_crossed(gt, lt);
    const uint32_t* tm = t_mask + tk * W;
    const uint32_t* gm = g_mask + gk * W;
    uint32_t* cm = c_mask + ck * W;
    uint32_t any = 0u;
    for (int w = 0; w < W; ++w) {
      const uint32_t x = crossed ? 0u : (tm[w] & gm[w]);
      cm[w] = x;
      any |= x;
    }
    // the combined mask is empty exactly when the pairwise intersection is
    // (a crossed key zeroes it), so one OR serves combine and compat
    const bool nonempty = any != 0u;
    const bool tdef = t_def[tk] != 0, gdef = g_def[gk] != 0;
    const bool tex = t_ex[tk] != 0, gex = g_ex[gk] != 0;
    const bool comp = t_comp[tk] != 0 && g_comp[gk] != 0 && !crossed;
    c_def[ck] = tdef || gdef;
    c_comp[ck] = comp;
    c_ex[ck] = comp ? (tex || gex) : !nonempty;
    // concrete results drop bounds (requirement.go:183-186)
    c_gt[ck] = comp ? gt : KT_INT_MIN;
    c_lt[ck] = comp ? lt : KT_INT_MAX;
    bad |= (tdef && gdef && !nonempty && !(tex && gex)) ||
           (gdef && !tdef && allow_undefined[k] == 0 && !gex);
  }
  bad = __any_sync(0xffffffffu, bad);
  if (threadIdx.x == 0) compat_tm[mg] = !bad;  // [M, G]: m * G + g == mg
}

extern "C" int kt_combine_compat(
    const void* t_mask, const void* t_def, const void* t_comp, const void* t_ex,
    const void* t_gt, const void* t_lt,
    const void* g_mask, const void* g_def, const void* g_comp, const void* g_ex,
    const void* g_gt, const void* g_lt, const void* allow_undefined,
    int M, int G, int K, int W,
    void* c_mask, void* c_def, void* c_comp, void* c_ex, void* c_gt,
    void* c_lt, void* compat_tm, void* stream) {
  combine_compat_kernel<<<M * G, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)t_mask, (const unsigned char*)t_def,
      (const unsigned char*)t_comp, (const unsigned char*)t_ex,
      (const int32_t*)t_gt, (const int32_t*)t_lt,
      (const uint32_t*)g_mask, (const unsigned char*)g_def,
      (const unsigned char*)g_comp, (const unsigned char*)g_ex,
      (const int32_t*)g_gt, (const int32_t*)g_lt,
      (const unsigned char*)allow_undefined, G, K, W,
      (uint32_t*)c_mask, (unsigned char*)c_def, (unsigned char*)c_comp,
      (unsigned char*)c_ex, (int32_t*)c_gt, (int32_t*)c_lt,
      (unsigned char*)compat_tm);
  return (int)cudaGetLastError();
}

// The message of an error code any launcher of the library returned.
extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
