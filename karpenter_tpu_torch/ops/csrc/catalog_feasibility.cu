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
// The [MG, T, O, Z] offering match the XLA program builds is never formed.
//
// Bound: operations. At 50k pods x 2k types (MG = 120, T = 2000, K = 9,
// W = 64) the intersects test is MG * T * K * W = 138M word ANDs over
// 4.6 MB of instance-type masks; everything else is O(MG * T * (R + O * Z)).
//
// Design: the mask join of feasibility_common.cuh with instance types on
// the A side and combined rows on the B side: per key a block copies its
// type tile's and row tile's mask words into a double-buffered shared ring
// (coalesced cp.async chunks) and each thread ANDs an RA x RB register tile
// of pairs from 16-byte shared loads. The tile sizes come from
// ops/kernels.py join_plan: 32 types x 32 rows at the north-star shape
// (252 blocks of 2 x 4 pairs a thread), 16 types x 8 rows at the disruption
// shape (MG = 8, T = 144: 9 blocks of one pair a thread, every key copied
// at once). The block's first copies also bring its epilogue inputs: the
// types' allocatable and offerings, the rows' daemon overhead, requests,
// capacity-type and zone mask words, template_its over the tile, and the
// zone values. Once they land, each offering's zone becomes its bit of the
// packed zone words (0 when unavailable) and each row's zone admission a
// word, so a pair's zone words are an OR over its type's offerings
// admitted by the row's capacity-type mask, ANDed with the row's
// admission: no thread reads offerings at a stride or loops over zones.
#include "feasibility_common.cuh"

// The block's own staging, after the join's regions.
struct KtCatalogExtra {
  double* rcp;                 // [TB, R]: 1 / req
  int32_t *alloc, *cv, *zone;  // [TA, R], [TA, O], [TA, O]
  uint32_t* zm;                // [TA, O, Wz]: the offering's zone bits
  int32_t *daemon, *req;       // [TB, R]
  uint32_t *crow, *zrow, *zadm;  // [TB, W], [TB, W], [TB, Wz]
  int32_t* zv;                 // [Z]: zone_values
  unsigned char *avail, *tits, *bok;  // [TA, O], [TB, TA], [TB]
};

__host__ __device__ inline size_t kt_catalog_extra_bytes(int TA, int TB,
                                                         int W, int R, int O,
                                                         int Wz, int Z) {
  return sizeof(double) * (size_t)TB * R +
         sizeof(int32_t) * ((size_t)TA * (R + 2 * O + (size_t)O * Wz) +
                            (size_t)TB * (2 * R + 2 * W + Wz) + Z) +
         (size_t)TA * O + (size_t)TB * TA + TB;
}

__device__ inline KtCatalogExtra kt_catalog_extra(unsigned char* p, int TA,
                                                  int TB, int W, int R, int O,
                                                  int Wz, int Z) {
  KtCatalogExtra e;
  e.rcp = (double*)p;
  e.alloc = (int32_t*)(e.rcp + (size_t)TB * R);
  e.cv = e.alloc + (size_t)TA * R;
  e.zone = e.cv + (size_t)TA * O;
  e.zm = (uint32_t*)(e.zone + (size_t)TA * O);
  e.daemon = (int32_t*)(e.zm + (size_t)TA * O * Wz);
  e.req = e.daemon + (size_t)TB * R;
  e.crow = (uint32_t*)(e.req + (size_t)TB * R);
  e.zrow = e.crow + (size_t)TB * W;
  e.zadm = e.zrow + (size_t)TB * W;
  e.zv = (int32_t*)(e.zadm + (size_t)TB * Wz);
  e.avail = (unsigned char*)(e.zv + Z);
  e.tits = e.avail + (size_t)TA * O;
  e.bok = e.tits + (size_t)TB * TA;
  return e;
}

struct KtCatalogArgs {
  const unsigned char* compat_tm;
  const int32_t *group_req, *daemon, *alloc;
  const unsigned char* template_its;
  const int32_t *off_zone, *off_captype;
  const unsigned char* off_avail;
  const int32_t* zone_values;
  const unsigned char* tol_template;
  int G, M, O, Z, R, zone_key, captype_key, word_bits, Wz;
  void* okz_out;
  int16_t* ppn_out;
  unsigned char* zone_adm_out;
};

template <int RA, int RB>
__global__ void __launch_bounds__(KT_JOIN_THREADS) catalog_feasibility_kernel(
    KtSide it, KtSide cmb, KtCatalogArgs a, int K, int W, int stages,
    bool vec) {
  constexpr int TA = KT_JOIN_TX * RA, TB = KT_JOIN_TY * RB;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = it.rows, G = a.G, M = a.M, R = a.R, O = a.O, Z = a.Z;
  const int Wz = a.Wz, wb = a.word_bits;
  const KtCatalogExtra s =
      kt_catalog_extra(smem + kt_join_layout(TA, TB, K, W, stages).extra, TA,
                       TB, W, R, O, Wz, Z);
  const int t0 = blockIdx.x * TA, mg0 = blockIdx.y * TB;
  const int nt = max(0, min(TA, T - t0)), nr = max(0, min(TB, cmb.rows - mg0));

  const uint32_t bad = kt_join<RA, RB>(
      it, cmb, K, W, stages, vec, smem, KtIntersectsPred(),
      [&] {
        kt_copy_words(s.alloc, a.alloc + (size_t)t0 * R, nt * R);
        kt_copy_words(s.cv, a.off_captype + (size_t)t0 * O, nt * O);
        kt_copy_words(s.zone, a.off_zone + (size_t)t0 * O, nt * O);
        kt_copy_bytes(s.avail, 0, a.off_avail + (size_t)t0 * O, 0, 1, nt * O);
        kt_copy_words(s.zv, a.zone_values, Z);
        const uint32_t daemon = (uint32_t)__cvta_generic_to_shared(s.daemon);
        const uint32_t req = (uint32_t)__cvta_generic_to_shared(s.req);
        for (int i = threadIdx.x; i < nr * R; i += KT_JOIN_THREADS) {
          const int mg = mg0 + i / R, r = i % R;
          kt_cp_async4(daemon + 4 * i, a.daemon + (size_t)(mg / G) * R + r);
          kt_cp_async4(req + 4 * i, a.group_req + (size_t)(mg % G) * R + r);
        }
        // the rows' capacity-type and zone mask words
        const uint32_t crow = (uint32_t)__cvta_generic_to_shared(s.crow);
        const uint32_t zrow = (uint32_t)__cvta_generic_to_shared(s.zrow);
        for (int i = threadIdx.x; i < nr * W; i += KT_JOIN_THREADS) {
          const uint32_t* row = cmb.mask + (size_t)(mg0 + i / W) * K * W;
          kt_cp_async4(crow + 4 * i, row + (size_t)a.captype_key * W + i % W);
          kt_cp_async4(zrow + 4 * i, row + (size_t)a.zone_key * W + i % W);
        }
        // template_its of each row's template over the type tile: whole
        // words when every row's run starts 4-byte aligned, else bytes
        const bool words = T % 4 == 0 && (uintptr_t)a.template_its % 4 == 0;
        const int nw = words ? nt / 4 : 0, tail = nt - 4 * nw;
        const uint32_t tits = (uint32_t)__cvta_generic_to_shared(s.tits);
        for (int i = threadIdx.x; i < nr * nw; i += KT_JOIN_THREADS) {
          const int b = i / nw, w = i % nw;
          kt_cp_async4(tits + b * TA + 4 * w,
                       a.template_its + (size_t)((mg0 + b) / G) * T + t0 +
                           4 * w);
        }
        for (int i = threadIdx.x; i < nr * tail; i += KT_JOIN_THREADS) {
          const int b = i / tail, t = 4 * nw + i % tail;
          s.tits[b * TA + t] =
              a.template_its[(size_t)((mg0 + b) / G) * T + t0 + t];
        }
        for (int b = threadIdx.x; b < nr; b += KT_JOIN_THREADS) {
          const int mg = mg0 + b, m = mg / G, g = mg % G;
          s.bok[b] = a.compat_tm[mg] != 0 &&
                     a.tol_template[(size_t)g * M + m] != 0;
        }
      },
      [&] {
        for (int i = threadIdx.x; i < nt * O; i += KT_JOIN_THREADS) {
          const int32_t zone = s.zone[i];
          const bool avail = s.avail[i] != 0;
          for (int wz = 0; wz < Wz; ++wz) {
            uint32_t word = 0u;
            for (int b = 0; b < wb && avail; ++b) {
              const int z = wz * wb + b;
              if (z >= Z) break;
              if (s.zv[z] == zone) word |= 1u << b;
            }
            s.zm[(size_t)i * Wz + wz] = word;
          }
        }
        for (int i = threadIdx.x; i < nr * Wz; i += KT_JOIN_THREADS) {
          const int wz = i % Wz;
          const uint32_t* zr = s.zrow + (size_t)(i / Wz) * W;
          uint32_t word = 0u;
          for (int b = 0; b < wb; ++b) {
            const int z = wz * wb + b;
            if (z >= Z) break;
            if (kt_bit_fill(zr, s.zv[z], W)) word |= 1u << b;
          }
          s.zadm[i] = word;
        }
        for (int i = threadIdx.x; i < nr * R; i += KT_JOIN_THREADS)
          s.rcp[i] = s.req[i] > 0 ? 1.0 / s.req[i] : 0.0;
        if (blockIdx.x == 0) {
          // zone admission of this tile's rows, once per row: [G, M, Z]
          for (int i = threadIdx.x; i < nr * Z; i += KT_JOIN_THREADS) {
            const int b = i / Z, z = i % Z, mg = mg0 + b;
            a.zone_adm_out[((size_t)(mg % G) * M + mg / G) * Z + z] =
                kt_bit_fill(s.zrow + (size_t)b * W, s.zv[z], W);
          }
        }
      });

  // The epilogue works resource by resource and offering by offering over
  // all the thread's pairs, so that their work is independent.
  const int ta = threadIdx.x % KT_JOIN_TX, tb = threadIdx.x / KT_JOIN_TX;
  int tl[RA], bl[RB];
#pragma unroll
  for (int i = 0; i < RA; ++i) tl[i] = ta + KT_JOIN_TX * i;
#pragma unroll
  for (int j = 0; j < RB; ++j) bl[j] = tb + KT_JOIN_TY * j;

  // pods per fresh node of type t under template m
  int32_t per[RA][RB];
  uint32_t unfit = 0u;  // bit i * RB + j: the daemon overhead does not fit
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) per[i][j] = KT_INT_MAX;
  for (int r = 0; r < R; ++r) {
    int32_t alloc[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i) alloc[i] = s.alloc[tl[i] * R + r];
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int32_t daemon = s.daemon[bl[j] * R + r];
      const int32_t req = s.req[bl[j] * R + r];
      const double rcp = s.rcp[bl[j] * R + r];
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int32_t free_r = kt_wrapping_sub(alloc[i], daemon);
        unfit |= (free_r < 0 ? 1u : 0u) << (i * RB + j);
        // free is clamped to >= 0 first, so truncation equals floor here
        const int32_t q = req > 0 ? kt_floordiv(max(free_r, 0), req, rcp)
                                  : (int32_t)(1 << 30);
        per[i][j] = min(per[i][j], q);
      }
    }
  }
  uint32_t ok = 0u;  // bit i * RB + j: ok_base
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const int mg = mg0 + bl[j], m = mg / G, g = mg % G;
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int bit = i * RB + j;
      const int32_t ppn = (unfit >> bit) & 1u ? 0 : per[i][j];
      const bool in = bl[j] < nr && tl[i] < nt;
      if (in)
        a.ppn_out[((size_t)g * M + m) * T + t0 + tl[i]] =
            (int16_t)min(max(ppn, 0), 32767);
      ok |= (in && !((bad >> bit) & 1u) && s.tits[bl[j] * TA + tl[i]] != 0 &&
             s.bok[bl[j]] != 0 && ppn >= 1)
                ? 1u << bit
                : 0u;
    }
  }

  // zone z's bit: the row admits the zone, and some available offering in
  // that zone has a capacity type the row admits
  for (int wz = 0; wz < Wz; ++wz) {
    uint32_t word[RA][RB];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) word[i][j] = 0u;
    for (int o = 0; o < O; ++o) {
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const uint32_t zm = s.zm[((size_t)tl[i] * O + o) * Wz + wz];
        const int32_t cv = s.cv[tl[i] * O + o];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const bool admitted =
              cv < 0 || kt_bit_clamp(s.crow + (size_t)bl[j] * W, cv, W);
          word[i][j] |= admitted ? zm : 0u;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int mg = mg0 + bl[j], m = mg / G, g = mg % G;
      const uint32_t zadm = s.zadm[bl[j] * Wz + wz];
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        if (bl[j] >= nr || tl[i] >= nt) continue;
        const uint32_t w =
            (ok >> (i * RB + j)) & 1u ? word[i][j] & zadm : 0u;
        const size_t idx = (((size_t)g * M + m) * T + t0 + tl[i]) * Wz + wz;
        if (wb == 8) ((uint8_t*)a.okz_out)[idx] = (uint8_t)w;
        else if (wb == 16) ((uint16_t*)a.okz_out)[idx] = (uint16_t)w;
        else ((uint32_t*)a.okz_out)[idx] = w;
      }
    }
  }
}

// Dynamic shared memory of one block of a tile_a x tile_b tile (ops/kernels.py
// join_smem mirrors it).
extern "C" size_t kt_catalog_feasibility_smem(int ta, int tb, int K, int W,
                                              int R, int O, int Wz, int Z,
                                              int stages) {
  return kt_join_layout(ta, tb, K, W, stages).extra +
         kt_catalog_extra_bytes(ta, tb, W, R, O, Wz, Z);
}

// The tiles the launches of chip_smoke.py's paths pick (its join_plans).
using CatalogTiles = KtTiles<KtTile<2, 4>, KtTile<1, 1>>;

// ra, rb, stages: the tile plan of ops/kernels.py join_plan.
extern "C" int kt_catalog_feasibility(
    const void* c_mask, const void* c_def, const void* c_ex, const void* c_gt,
    const void* c_lt, const void* compat_tm,
    const void* i_mask, const void* i_def, const void* i_ex, const void* i_gt,
    const void* i_lt, const void* group_req, const void* daemon,
    const void* alloc, const void* template_its, const void* off_zone,
    const void* off_captype, const void* off_avail, const void* zone_values,
    const void* tol_template,
    int G, int M, int T, int K, int W, int R, int O, int Z,
    int zone_key, int captype_key, int word_bits, int Wz, int ra, int rb,
    int stages, void* okz_out, void* ppn_out, void* zone_adm_out,
    void* stream) {
  const KtSide cmb{(const uint32_t*)c_mask, (const unsigned char*)c_def,
                   (const unsigned char*)c_ex, (const int32_t*)c_gt,
                   (const int32_t*)c_lt, M * G};
  const KtSide it{(const uint32_t*)i_mask, (const unsigned char*)i_def,
                  (const unsigned char*)i_ex, (const int32_t*)i_gt,
                  (const int32_t*)i_lt, T};
  const KtCatalogArgs a{
      (const unsigned char*)compat_tm, (const int32_t*)group_req,
      (const int32_t*)daemon, (const int32_t*)alloc,
      (const unsigned char*)template_its, (const int32_t*)off_zone,
      (const int32_t*)off_captype, (const unsigned char*)off_avail,
      (const int32_t*)zone_values, (const unsigned char*)tol_template,
      G, M, O, Z, R, zone_key, captype_key, word_bits, Wz,
      okz_out, (int16_t*)ppn_out, (unsigned char*)zone_adm_out};
  const bool vec = W % 4 == 0 && ((uintptr_t)c_mask % 16) == 0 &&
                   ((uintptr_t)i_mask % 16) == 0;
  const cudaError_t err = CatalogTiles::dispatch(ra, rb, [&](auto tile) {
    constexpr int RA = decltype(tile)::ra, RB = decltype(tile)::rb;
    constexpr int TA = KT_JOIN_TX * RA, TB = KT_JOIN_TY * RB;
    const size_t smem =
        kt_catalog_feasibility_smem(TA, TB, K, W, R, O, Wz, Z, stages);
    cudaError_t e = kt_allow_smem(catalog_feasibility_kernel<RA, RB>, smem);
    if (e != cudaSuccess) return e;
    // at least one column of blocks: the first column writes zone_adm even
    // when the catalog is empty
    dim3 grid(T > 0 ? (T + TA - 1) / TA : 1, (M * G + TB - 1) / TB);
    catalog_feasibility_kernel<RA, RB>
        <<<grid, KT_JOIN_THREADS, smem, (cudaStream_t)stream>>>(
            it, cmb, a, K, W, stages, vec);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) cudaGetLastError();  // clear it for the next launch
  return (int)err;
}
