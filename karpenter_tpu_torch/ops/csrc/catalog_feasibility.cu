// K2 catalog_feasibility: the catalog side of the provisioning feasibility
// precompute.
//
// Replaces the rest of karpenter_tpu/ops/binpack.py precompute_kernel
// (lines 177-219 and 234): per combined row mg = m * G + g and instance
// type t,
//   - intersects_matrix(it, cmb): every key both sides define must keep a
//     nonempty mask AND (after the joint Gt/Lt collapse) unless both sides
//     are exempt;
//   - zone admission: the bits of cmb's zone key at each zone value (a
//     value past the mask's words admitted, as jnp.take fills);
//   - offerings: available, capacity-type value admitted (-1 ==
//     unconstrained, never read; a value past the words reads the last
//     word, as the reference's gather clamps), zone index equal to the
//     zone's value;
//   - pods_per_node: min over resources of max(alloc - daemon, 0) // req,
//     2^30 for a zero request, 0 when the daemon overhead does not fit;
//   - the AND of those with template_its, tol_template, compat_tm and
//     ppn >= 1, packed into Wz zone words of 8, 16 or 32 bits
//     (zone_pack_layout), plus ppn clipped to int16 and zone_adm [G, M, Z].
// The [MG, T, O, Z] offering match the XLA program builds is never formed:
// offerings and zones loop in registers.
//
// Bound: operations. At 50k pods x 2k types (MG = 120, T = 2000, K = 9,
// W = 64) the intersects test is MG * T * K * W = 138M word ANDs over
// 4.6 MB of instance-type masks; everything else is O(MG * T * (R + O * Z)).
//
// Design: a block of 128 threads covers 128 consecutive instance types for
// a tile of up to KT_TILE_MAX combined rows held in shared memory. Each
// thread reads each of its type's mask words once and ANDs it against the
// whole tile (shared-memory broadcast), so the catalog masks stream from
// L2 MG / tile times instead of MG times. Outputs are written with the
// type index fastest, so stores coalesce.
#include "feasibility_common.cuh"

__global__ void catalog_feasibility_kernel(
    const uint32_t* __restrict__ c_mask, const unsigned char* __restrict__ c_def,
    const unsigned char* __restrict__ c_ex, const int32_t* __restrict__ c_gt,
    const int32_t* __restrict__ c_lt, const unsigned char* __restrict__ compat_tm,
    const uint32_t* __restrict__ i_mask, const unsigned char* __restrict__ i_def,
    const unsigned char* __restrict__ i_ex, const int32_t* __restrict__ i_gt,
    const int32_t* __restrict__ i_lt,
    const int32_t* __restrict__ group_req, const int32_t* __restrict__ daemon,
    const int32_t* __restrict__ alloc, const unsigned char* __restrict__ template_its,
    const int32_t* __restrict__ off_zone, const int32_t* __restrict__ off_captype,
    const unsigned char* __restrict__ off_avail, const int32_t* __restrict__ zone_values,
    const unsigned char* __restrict__ tol_template,
    int G, int M, int T, int K, int W, int R, int O, int Z,
    int zone_key, int captype_key, int tile, int word_bits, int Wz,
    void* __restrict__ okz_out, int16_t* __restrict__ ppn_out,
    unsigned char* __restrict__ zone_adm_out) {
  extern __shared__ uint32_t s_cmb[];  // [tile, K, W]
  const int MG = M * G;
  const int mg0 = blockIdx.y * tile;
  const int nt = min(tile, MG - mg0);
  const size_t row_words = (size_t)K * W;
  for (size_t i = threadIdx.x; i < (size_t)nt * row_words; i += blockDim.x)
    s_cmb[i] = c_mask[(size_t)mg0 * row_words + i];
  __syncthreads();

  if (blockIdx.x == 0) {
    // zone admission of this tile's rows, once per row: [G, M, Z]
    for (int i = threadIdx.x; i < nt * Z; i += blockDim.x) {
      const int j = i / Z, z = i % Z;
      const int mg = mg0 + j;
      const uint32_t* zrow = s_cmb + (size_t)j * row_words + (size_t)zone_key * W;
      zone_adm_out[((size_t)(mg % G) * M + mg / G) * Z + z] =
          kt_bit_fill(zrow, zone_values[z], W);
    }
  }

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;

  bool bad[KT_TILE_MAX];
#pragma unroll
  for (int j = 0; j < KT_TILE_MAX; ++j) bad[j] = false;
  uint32_t acc[KT_TILE_MAX];
  for (int k = 0; k < K; ++k) {
    const size_t tk = (size_t)t * K + k;
    kt_and_words(i_mask + tk * W, s_cmb, nt, k, K, W, acc);
    const bool idef = i_def[tk] != 0, iex = i_ex[tk] != 0;
    const int32_t igt = i_gt[tk], ilt = i_lt[tk];
#pragma unroll
    for (int j = 0; j < KT_TILE_MAX; ++j) {
      if (j >= nt) break;
      const size_t ck = (size_t)(mg0 + j) * K + k;
      const bool nonempty =
          acc[j] != 0u && !kt_crossed(max(igt, c_gt[ck]), min(ilt, c_lt[ck]));
      bad[j] |= idef && c_def[ck] != 0 && !nonempty && !(iex && c_ex[ck] != 0);
    }
  }

#pragma unroll
  for (int j = 0; j < KT_TILE_MAX; ++j) {
    if (j >= nt) break;
    const int mg = mg0 + j;
    const int m = mg / G, g = mg % G;

    // pods per fresh node of type t under template m
    bool daemon_fits = true;
    int32_t per = KT_INT_MAX;
    for (int r = 0; r < R; ++r) {
      const int32_t free_r = kt_wrapping_sub(alloc[(size_t)t * R + r],
                                             daemon[(size_t)m * R + r]);
      daemon_fits = daemon_fits && free_r >= 0;
      const int32_t req = group_req[(size_t)g * R + r];
      // free is clamped to >= 0 first, so truncation equals floor here
      per = min(per, req > 0 ? max(free_r, 0) / req : (int32_t)(1 << 30));
    }
    const int32_t ppn = daemon_fits ? per : 0;
    const size_t out = ((size_t)g * M + m) * T + t;
    ppn_out[out] = (int16_t)min(max(ppn, 0), 32767);

    const bool ok_base = !bad[j] && template_its[(size_t)m * T + t] != 0 &&
                         tol_template[(size_t)g * M + m] != 0 &&
                         compat_tm[mg] != 0 && ppn >= 1;

    // zone z's bit: the row admits the zone, and some available offering
    // in that zone has a capacity type the row admits
    const uint32_t* srow = s_cmb + (size_t)j * row_words;
    const uint32_t* zrow = srow + (size_t)zone_key * W;
    const uint32_t* crow = srow + (size_t)captype_key * W;
    const size_t t0 = (size_t)t * O;
    for (int wz = 0; wz < Wz; ++wz) {
      uint32_t word = 0u;
      for (int b = 0; b < word_bits && ok_base; ++b) {
        const int z = wz * word_bits + b;
        if (z >= Z) break;
        const int32_t zv = zone_values[z];
        if (!kt_bit_fill(zrow, zv, W)) continue;
        for (int o = 0; o < O; ++o) {
          if (off_avail[t0 + o] == 0 || off_zone[t0 + o] != zv) continue;
          const int32_t cv = off_captype[t0 + o];
          if (cv < 0 || kt_bit_clamp(crow, cv, W)) {
            word |= 1u << b;
            break;
          }
        }
      }
      const size_t idx = out * Wz + wz;
      if (word_bits == 8) ((uint8_t*)okz_out)[idx] = (uint8_t)word;
      else if (word_bits == 16) ((uint16_t*)okz_out)[idx] = (uint16_t)word;
      else ((uint32_t*)okz_out)[idx] = word;
    }
  }
}

extern "C" int kt_catalog_feasibility(
    const void* c_mask, const void* c_def, const void* c_ex, const void* c_gt,
    const void* c_lt, const void* compat_tm,
    const void* i_mask, const void* i_def, const void* i_ex, const void* i_gt,
    const void* i_lt, const void* group_req, const void* daemon,
    const void* alloc, const void* template_its, const void* off_zone,
    const void* off_captype, const void* off_avail, const void* zone_values,
    const void* tol_template,
    int G, int M, int T, int K, int W, int R, int O, int Z,
    int zone_key, int captype_key, int word_bits, int Wz,
    void* okz_out, void* ppn_out, void* zone_adm_out, void* stream) {
  const int tile = kt_tile(K, W, M * G);
  const size_t smem = (size_t)tile * K * W * sizeof(uint32_t);
  cudaError_t err = kt_allow_smem(catalog_feasibility_kernel, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return (int)err;
  }
  const int threads = 128;
  // at least one column of blocks: block x == 0 writes zone_adm even when
  // the catalog is empty
  const int col_blocks = T > 0 ? (T + threads - 1) / threads : 1;
  dim3 grid(col_blocks, (M * G + tile - 1) / tile);
  catalog_feasibility_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)c_mask, (const unsigned char*)c_def,
      (const unsigned char*)c_ex, (const int32_t*)c_gt, (const int32_t*)c_lt,
      (const unsigned char*)compat_tm,
      (const uint32_t*)i_mask, (const unsigned char*)i_def,
      (const unsigned char*)i_ex, (const int32_t*)i_gt, (const int32_t*)i_lt,
      (const int32_t*)group_req, (const int32_t*)daemon, (const int32_t*)alloc,
      (const unsigned char*)template_its, (const int32_t*)off_zone,
      (const int32_t*)off_captype, (const unsigned char*)off_avail,
      (const int32_t*)zone_values, (const unsigned char*)tol_template,
      G, M, T, K, W, R, O, Z, zone_key, captype_key, tile, word_bits, Wz,
      okz_out, (int16_t*)ppn_out, (unsigned char*)zone_adm_out);
  return (int)cudaGetLastError();
}
