// Shared device helpers of the feasibility kernels (combine_compat.cu,
// catalog_feasibility.cu, exist_feasibility.cu), and the tiled "mask join"
// core of the last two.
//
// Encoded requirement rows follow ops/encode.py: per key a bit mask of
// W uint32 words, defined / complement / exempt flags (one byte each) and
// int32 Gt/Lt bounds whose INT_MIN / INT_MAX values mean "unbounded".
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KT_INT_MIN (-2147483647 - 1)
#define KT_INT_MAX 2147483647

// Joint Gt/Lt collapse (requirement.go:163-165): both bounds set and
// max(gt) >= min(lt) empties the intersection.
__device__ __forceinline__ bool kt_crossed(int32_t gt, int32_t lt) {
  return (gt > KT_INT_MIN) & (lt < KT_INT_MAX) & (gt >= lt);
}

// int32 subtraction that wraps as XLA's and torch's int32 arithmetic do
// (signed overflow is undefined in C++).
__device__ __forceinline__ int32_t kt_wrapping_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// Bit `v` of one key's mask row of W words (v >= 0). The reference reads
// a value index at or past 32 * W in two ways, and neither reads past the
// row: jnp.take fills with all ones (kt_bit_fill: admitted), a plain
// gather clamps to the last word (kt_bit_clamp).
__device__ __forceinline__ bool kt_bit_fill(const uint32_t* row, int32_t v,
                                            int W) {
  const int32_t word = v >> 5;
  return word >= W || ((row[word] >> (v & 31)) & 1u);
}

__device__ __forceinline__ bool kt_bit_clamp(const uint32_t* row, int32_t v,
                                             int W) {
  return (row[min(v >> 5, W - 1)] >> (v & 31)) & 1u;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
__host__ inline cudaError_t kt_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Floor division for b >= 1 (jnp's and torch's `//`; C's `/` truncates),
// given rcp = 1.0 / b in double precision: the product is within 2^-21 of
// a / b for any int32 a, so its floor is off by at most one, and the
// remainder corrects it. One multiply and one conversion where an int32
// division takes a long instruction sequence.
__device__ __forceinline__ int32_t kt_floordiv(int32_t a, int32_t b,
                                               double rcp) {
  int32_t q = __double2int_rd((double)a * rcp);
  const long long r = (long long)a - (long long)q * b;
  if (r < 0) --q;
  else if (r >= b) ++q;
  return q;
}

// ---------------------------------------------------------------------------
// The mask join: for every pair (a, b) of an A-side row set and a B-side row
// set of encoded requirements, fold over the K keys a predicate of "the two
// masks of key k share a bit", both rows' defined / exempt flags and their
// joint Gt/Lt bounds.
//
// A block of KT_JOIN_THREADS threads owns a tile of TA = 16 * RA A-rows and
// TB = 8 * RB B-rows. Thread (ta, tb) = (tid % 16, tid / 16) owns the RA x RB
// pairs of A-rows ta + 16 i and B-rows tb + 8 j.
//
// - Copies. Every global read of a block is an asynchronous copy
//   (cp.async) into shared memory: the first group holds the first key's
//   mask words, both tiles' flags and bounds and the calling kernel's
//   epilogue inputs, so the block waits for one round trip before it
//   computes (a separate group for the mask words, landing while the rest
//   is unpacked, measured no faster). Per key, both tiles' W mask words go
//   into a ring of stages (16-byte chunks when rows are 16-byte aligned,
//   else words): consecutive threads copy consecutive chunks of a row, so
//   the node-major [rows, K, W] layout is read coalesced, each word once
//   per block. With two stages the next key's copy overlaps this key's
//   ANDs (three or four measured no faster); when the whole join fits
//   (small W) the first group holds every key.
// - ANDs. A thread reads 16-byte vectors of its rows' words and accumulates
//   acc |= a & b (one LOP3 per word pair): RA + RB shared loads feed
//   4 * RA * RB ANDs. A row occupies an odd number of 16-byte chunks, so the
//   eight threads of a quarter warp (eight consecutive A-rows) read eight
//   distinct bank groups; they share one B-row, which is a broadcast.
// - Predicate. Per key a pair keeps one bit, "nonempty": acc != 0 and, only
//   for keys where some row of the tile has a bound, the joint Gt/Lt not
//   crossed. Every 32 keys the pair's bits meet both rows' defined and
//   exempt flags, packed 32 keys to a word, in a few word operations.
// - Epilogues work resource by resource (and offering by offering) over all
//   of a thread's pairs, without branches, so the pairs' work overlaps.
//
// Host and device agree on the shared-memory layout through
// kt_join_layout; ops/kernels.py join_smem mirrors its sizes.
// ---------------------------------------------------------------------------

#define KT_JOIN_THREADS 128
#define KT_JOIN_TX 16  // threads along A
#define KT_JOIN_TY 8   // threads along B
#define KT_SMEM_ALIGN 16

__host__ __device__ inline size_t kt_align(size_t x) {
  return (x + KT_SMEM_ALIGN - 1) / KT_SMEM_ALIGN * KT_SMEM_ALIGN;
}

// A row's stride in the ring, in 16-byte chunks: W rounded up to whole
// chunks, then to an odd count (bank-group rotation between rows).
__host__ __device__ inline int kt_row_chunks(int W) {
  return ((W + 3) / 4) | 1;
}

// Byte offsets of the join's regions in dynamic shared memory; `extra` is
// where the calling kernel's own staging starts.
struct KtJoinLayout {
  size_t ring, gt_a, lt_a, gt_b, lt_b, def_a, ex_a, def_b, ex_b, word_a,
      word_b, bounds, extra;
};

__host__ __device__ inline KtJoinLayout kt_join_layout(int TA, int TB, int K,
                                                       int W, int stages) {
  // ring [stages, TA + TB, rc * 4] u32; gt, lt [TA or TB, K] i32 and def, ex
  // [TA or TB, K] u8 as the encoding holds them; word_a / word_b [groups,
  // TA or TB] uint2 and bounds [groups] u32 (groups = the 32-key words of K)
  const size_t groups = (K + 31) / 32;
  const size_t ia = kt_align((size_t)K * TA * 4);
  const size_t ib = kt_align((size_t)K * TB * 4);
  const size_t ba = kt_align((size_t)K * TA), bb = kt_align((size_t)K * TB);
  KtJoinLayout l;
  l.ring = 0;
  l.gt_a = kt_align((size_t)stages * (TA + TB) * kt_row_chunks(W) * 16);
  l.lt_a = l.gt_a + ia;
  l.gt_b = l.lt_a + ia;
  l.lt_b = l.gt_b + ib;
  l.def_a = l.lt_b + ib;
  l.ex_a = l.def_a + ba;
  l.def_b = l.ex_a + ba;
  l.ex_b = l.def_b + bb;
  l.word_a = l.ex_b + bb;
  l.word_b = l.word_a + kt_align(groups * TA * 8);
  l.bounds = l.word_b + kt_align(groups * TB * 8);
  l.extra = l.bounds + kt_align(groups * 4);
  return l;
}

// One side of a join: the encoded rows [rows, K, W] and [rows, K].
struct KtSide {
  const uint32_t* mask;
  const unsigned char* def;
  const unsigned char* ex;
  const int32_t* gt;
  const int32_t* lt;
  int rows;
};

__device__ __forceinline__ void kt_cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void kt_cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void kt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void kt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n 32-bit words from global `src` to shared `dst`, one cp.async each.
__device__ __forceinline__ void kt_copy_words(void* dst, const void* src,
                                              int n) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const uint32_t* s = (const uint32_t*)src;
  for (int i = threadIdx.x; i < n; i += KT_JOIN_THREADS)
    kt_cp_async4(d + 4 * i, s + i);
}

// rows x n bytes, row r from src + r * src_stride to shared dst + r *
// dst_stride: whole words through cp.async when the rows start 4-byte
// aligned on both sides, the rest by plain loads.
__device__ __forceinline__ void kt_copy_bytes(unsigned char* dst,
                                              int dst_stride,
                                              const unsigned char* src,
                                              size_t src_stride, int rows,
                                              int n) {
  const bool aligned = (uintptr_t)src % 4 == 0 && src_stride % 4 == 0 &&
                       dst_stride % 4 == 0 &&
                       __cvta_generic_to_shared(dst) % 4 == 0;
  const int nw = aligned ? n / 4 : 0, tail = n - 4 * nw;
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  for (int i = threadIdx.x; i < rows * nw; i += KT_JOIN_THREADS) {
    const int r = i / nw, w = i % nw;
    kt_cp_async4(d + r * dst_stride + 4 * w, src + r * src_stride + 4 * w);
  }
  for (int i = threadIdx.x; i < rows * tail; i += KT_JOIN_THREADS) {
    const int r = i / tail, b = 4 * nw + i % tail;
    dst[r * dst_stride + b] = src[r * src_stride + b];
  }
}

// Copy one key's W words of n rows: row r from src0 + r * K * W (global) to
// the shared address dst0 + r * rc * 16. `U` bytes a copy (16 or 4); each
// thread keeps one column of the rows and steps its pointers.
template <int U>
__device__ __forceinline__ void kt_copy_rows(uint32_t dst0,
                                             const uint32_t* src0, int n,
                                             int K, int W, int rc) {
  const int units = W * 4 / U;
  const size_t row_words = (size_t)K * W;
  if (units <= KT_JOIN_THREADS) {
    const int step = KT_JOIN_THREADS / units, u = threadIdx.x % units;
    int r = threadIdx.x / units;
    if (r >= step) return;
    const uint32_t* src = src0 + r * row_words + u * (U / 4);
    uint32_t dst = dst0 + r * rc * 16 + u * U;
    const size_t src_step = step * row_words;
    const uint32_t dst_step = step * rc * 16;
    for (; r < n; r += step, src += src_step, dst += dst_step)
      if (U == 16) kt_cp_async16(dst, src);
      else kt_cp_async4(dst, src);
  } else {
    for (int r = 0; r < n; ++r)
      for (int u = threadIdx.x; u < units; u += KT_JOIN_THREADS) {
        const void* src = src0 + r * row_words + u * (U / 4);
        if (U == 16) kt_cp_async16(dst0 + r * rc * 16 + u * U, src);
        else kt_cp_async4(dst0 + r * rc * 16 + u * U, src);
      }
  }
}

// Key k's mask words of the tile's na A-rows (from a0) and nb B-rows (from
// b0) into the ring stage at shared address `stage`: A-rows at stage rows
// [0, na), B-rows at [TA, TA + nb).
__device__ __forceinline__ void kt_copy_key(uint32_t stage, const KtSide& A,
                                            const KtSide& B, int a0, int na,
                                            int b0, int nb, int TA, int k,
                                            int K, int W, int rc, bool vec) {
  if (W == 0) return;
  const uint32_t* sa = A.mask + ((size_t)a0 * K + k) * W;
  const uint32_t* sb = B.mask + ((size_t)b0 * K + k) * W;
  const uint32_t stage_b = stage + TA * rc * 16;
  if (vec) {
    kt_copy_rows<16>(stage, sa, na, K, W, rc);
    kt_copy_rows<16>(stage_b, sb, nb, K, W, rc);
  } else {
    kt_copy_rows<4>(stage, sa, na, K, W, rc);
    kt_copy_rows<4>(stage_b, sb, nb, K, W, rc);
  }
}

// The predicates over 32 keys at once, folded into a pair's `bad` bit: `ne`
// holds the pair's "nonempty" bit of each key, `a` and `b` each row's
// (defined, exempt) words.
//
// K3: compatible_matrix(exist = A, group = B) without allow-undefined: a key
// both define must be nonempty unless both are exempt, and a key the group
// defines and the node does not must be exempt on the group's side.
struct KtCompatiblePred {
  __device__ __forceinline__ bool operator()(uint32_t ne, uint2 a,
                                             uint2 b) const {
    return ((a.x & b.x & ~(a.y & b.y) & ~ne) | (b.x & ~a.x & ~b.y)) != 0u;
  }
};

// K2: intersects_matrix(it = A, cmb = B).
struct KtIntersectsPred {
  __device__ __forceinline__ bool operator()(uint32_t ne, uint2 a,
                                             uint2 b) const {
    return (a.x & b.x & ~(a.y & b.y) & ~ne) != 0u;
  }
};

// A tile's per-(row, key) bounds and flags, copied as the encoding holds
// them ([rows, K]: the tile's rows are contiguous).
__device__ __forceinline__ void kt_copy_meta(const KtSide& S, int r0, int n,
                                             int K, int32_t* gt, int32_t* lt,
                                             unsigned char* def,
                                             unsigned char* ex) {
  const size_t o = (size_t)r0 * K;
  kt_copy_words(gt, S.gt + o, n * K);
  kt_copy_words(lt, S.lt + o, n * K);
  kt_copy_bytes(def, 0, S.def + o, 0, 1, n * K);
  kt_copy_bytes(ex, 0, S.ex + o, 0, 1, n * K);
}

// Pack each row's flags 32 keys to a word, (defined, exempt) per group, and
// OR the group's bounded keys of all rows into the tile's `bounds` words (one
// shared atomic per warp).
__device__ __forceinline__ void kt_pack_rows(int na, int nb, int TA, int TB,
                                             int K, const KtJoinLayout& L,
                                             unsigned char* smem) {
  for (int g = 0; g * 32 < K; ++g) {
    uint32_t hb = 0u;
    for (int r = threadIdx.x; r < na + nb; r += KT_JOIN_THREADS) {
      const bool a = r < na;
      const int row = a ? r : r - na, rows = a ? TA : TB;
      const int32_t* gt = (const int32_t*)(smem + (a ? L.gt_a : L.gt_b));
      const int32_t* lt = (const int32_t*)(smem + (a ? L.lt_a : L.lt_b));
      const unsigned char* def = smem + (a ? L.def_a : L.def_b);
      const unsigned char* ex = smem + (a ? L.ex_a : L.ex_b);
      uint32_t d = 0u, e = 0u;
      for (int kk = 0; kk < 32 && g * 32 + kk < K; ++kk) {
        const int i = row * K + g * 32 + kk;
        d |= (def[i] != 0 ? 1u : 0u) << kk;
        e |= (ex[i] != 0 ? 1u : 0u) << kk;
        hb |= (gt[i] > KT_INT_MIN || lt[i] < KT_INT_MAX ? 1u : 0u) << kk;
      }
      uint2* words = (uint2*)(smem + (a ? L.word_a : L.word_b));
      words[g * rows + row] = make_uint2(d, e);
    }
    hb = __reduce_or_sync(0xffffffffu, hb);
    if (hb && threadIdx.x % 32 == 0)
      atomicOr((unsigned*)(smem + L.bounds) + g, hb);
  }
}

// The join of one block's tile. Returns the thread's bad bits, bit
// i * RB + j for its pair (A-row ta + 16 i, B-row tb + 8 j) of the tile.
// Every global read of the block is one group of asynchronous copies:
// `fetch()` adds the calling kernel's epilogue inputs to it (shared-memory
// destinations), and `derive()` runs once they have landed, to compute what
// the epilogue needs from them; its writes are visible on return.
template <int RA, int RB, class Pred, class Fetch, class Derive>
__device__ __forceinline__ uint32_t kt_join(const KtSide& A, const KtSide& B,
                                            int K, int W, int stages,
                                            bool vec, unsigned char* smem,
                                            Pred pred, Fetch fetch,
                                            Derive derive) {
  constexpr int TA = KT_JOIN_TX * RA, TB = KT_JOIN_TY * RB;
  const KtJoinLayout L = kt_join_layout(TA, TB, K, W, stages);
  uint32_t* ring = (uint32_t*)(smem + L.ring);
  int32_t* gt_a = (int32_t*)(smem + L.gt_a);
  int32_t* lt_a = (int32_t*)(smem + L.lt_a);
  int32_t* gt_b = (int32_t*)(smem + L.gt_b);
  int32_t* lt_b = (int32_t*)(smem + L.lt_b);
  const uint2* word_a = (const uint2*)(smem + L.word_a);
  const uint2* word_b = (const uint2*)(smem + L.word_b);
  unsigned* bounds = (unsigned*)(smem + L.bounds);

  const int rc = kt_row_chunks(W);
  const int chunks = (W + 3) / 4;
  const size_t stage_words = (size_t)(TA + TB) * rc * 4;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const int a0 = blockIdx.x * TA, b0 = blockIdx.y * TB;
  const int na = max(0, min(TA, A.rows - a0));
  const int nb = max(0, min(TB, B.rows - b0));
  const bool resident = stages >= K;

  // the words past W of the last chunk take part in the ANDs and no copy
  // writes them: zero them once
  if (W % 4)
    for (int i = threadIdx.x; i < stages * (TA + TB); i += KT_JOIN_THREADS)
      for (int w = W; w < chunks * 4; ++w) ring[(size_t)i * rc * 4 + w] = 0u;
  for (int g = threadIdx.x; g * 32 < K; g += KT_JOIN_THREADS) bounds[g] = 0u;
  const int first = resident ? K : min(K, 1);
  for (int k = 0; k < first; ++k)
    kt_copy_key(ring_s + k * stage_words * 4, A, B, a0, na, b0, nb, TA, k,
                K, W, rc, vec);
  kt_copy_meta(A, a0, na, K, gt_a, lt_a, smem + L.def_a, smem + L.ex_a);
  kt_copy_meta(B, b0, nb, K, gt_b, lt_b, smem + L.def_b, smem + L.ex_b);
  fetch();
  kt_cp_commit();
  kt_cp_wait<0>();
  __syncthreads();
  kt_pack_rows(na, nb, TA, TB, K, L, smem);
  derive();
  __syncthreads();

  const int ta = threadIdx.x % KT_JOIN_TX, tb = threadIdx.x / KT_JOIN_TX;
  uint32_t bad = 0u;
  uint32_t ne[RA][RB];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) ne[i][j] = 0u;
  for (int k = 0; k < K; ++k) {
    const uint32_t* stage;
    if (resident) {
      stage = ring + k * stage_words;
    } else {
      if (k + 1 < K) {
        kt_copy_key(ring_s + ((k + 1) & 1) * stage_words * 4, A, B, a0, na,
                    b0, nb, TA, k + 1, K, W, rc, vec);
        kt_cp_commit();
        kt_cp_wait<1>();
      } else {
        kt_cp_wait<0>();
      }
      __syncthreads();
      stage = ring + (k & 1) * stage_words;
    }
    const uint4* sa = (const uint4*)stage;
    const uint4* sb = sa + (size_t)TA * rc;
    uint32_t acc[RA][RB];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[i][j] = 0u;
#pragma unroll 2
    for (int c = 0; c < chunks; ++c) {
      uint4 a[RA];
#pragma unroll
      for (int i = 0; i < RA; ++i) a[i] = sa[(ta + KT_JOIN_TX * i) * rc + c];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const uint4 b = sb[(tb + KT_JOIN_TY * j) * rc + c];
#pragma unroll
        for (int i = 0; i < RA; ++i) {
          uint32_t x = acc[i][j];
          x |= a[i].x & b.x;
          x |= a[i].y & b.y;
          x |= a[i].z & b.z;
          x |= a[i].w & b.w;
          acc[i][j] = x;
        }
      }
    }
    const uint32_t bit = 1u << (k & 31);
    if (bounds[k >> 5] & bit) {
      // some row of the tile bounds this key: the joint Gt/Lt collapse
      int32_t bgt[RB], blt[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        bgt[j] = gt_b[(tb + KT_JOIN_TY * j) * K + k];
        blt[j] = lt_b[(tb + KT_JOIN_TY * j) * K + k];
      }
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int32_t agt = gt_a[(ta + KT_JOIN_TX * i) * K + k];
        const int32_t alt = lt_a[(ta + KT_JOIN_TX * i) * K + k];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const bool keep = (acc[i][j] != 0u) &
                            !kt_crossed(max(agt, bgt[j]), min(alt, blt[j]));
          ne[i][j] |= keep ? bit : 0u;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) ne[i][j] |= acc[i][j] != 0u ? bit : 0u;
    }
    if ((k & 31) == 31 || k + 1 == K) {
      const int g = k >> 5;
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const uint2 wa = word_a[g * TA + ta + KT_JOIN_TX * i];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          if (pred(ne[i][j], wa, word_b[g * TB + tb + KT_JOIN_TY * j]))
            bad |= 1u << (i * RB + j);
          ne[i][j] = 0u;
        }
      }
    }
    if (!resident) __syncthreads();  // the stage is overwritten next key
  }
  return bad;
}

// A register tile: RA A-rows x RB B-rows a thread.
template <int RA, int RB>
struct KtTile {
  static constexpr int ra = RA, rb = RB;
};

// The register tiles a join kernel is built for (ops/kernels.py
// JOIN_MICRO_TILES lists the same): dispatch(ra, rb, f) returns f(tile) for
// the tile (ra, rb), cudaErrorInvalidValue for any other.
template <class... Tiles>
struct KtTiles {
  template <class F>
  __host__ static cudaError_t dispatch(int ra, int rb, F f) {
    cudaError_t err = cudaErrorInvalidValue;
    ((ra == Tiles::ra && rb == Tiles::rb ? (err = f(Tiles()), true)
                                         : false) ||
     ...);
    return err;
  }
};
