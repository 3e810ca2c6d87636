// Shared device helpers of the feasibility kernels (combine_compat.cu,
// catalog_feasibility.cu, exist_feasibility.cu).
//
// Encoded requirement rows follow ops/encode.py: per key a bit mask of
// W uint32 words, defined / complement / exempt flags (one byte each) and
// int32 Gt/Lt bounds whose INT_MIN / INT_MAX values mean "unbounded".
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KT_INT_MIN (-2147483647 - 1)
#define KT_INT_MAX 2147483647

// Most rows of the combined (template x group) side a block of
// catalog_feasibility / exist_feasibility holds in shared memory and tests
// each of its own rows against; the accumulators live in registers.
#define KT_TILE_MAX 8

// Joint Gt/Lt collapse (requirement.go:163-165): both bounds set and
// max(gt) >= min(lt) empties the intersection.
__device__ __forceinline__ bool kt_crossed(int32_t gt, int32_t lt) {
  return gt > KT_INT_MIN && lt < KT_INT_MAX && gt >= lt;
}

// int32 subtraction that wraps as XLA's and torch's int32 arithmetic do
// (signed overflow is undefined in C++).
__device__ __forceinline__ int32_t kt_wrapping_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// Floor division for b >= 1 (jnp's and torch's `//`); C's `/` truncates.
__device__ __forceinline__ int32_t kt_floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b) != 0 && a < 0) --q;
  return q;
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

// A rows-x-tile pass over the mask words: for each of `nt` shared-memory
// rows j, acc[j] = OR over w of (row[w] & tile[j][k][w]) for one key k.
// `row` is the thread's own [W] words of key k in device memory, read once
// for the whole tile.
__device__ __forceinline__ void kt_and_words(const uint32_t* __restrict__ row,
                                             const uint32_t* tile, int nt,
                                             int k, int K, int W,
                                             uint32_t acc[KT_TILE_MAX]) {
#pragma unroll
  for (int j = 0; j < KT_TILE_MAX; ++j) acc[j] = 0u;
  for (int w = 0; w < W; ++w) {
    const uint32_t x = __ldg(row + w);
#pragma unroll
    for (int j = 0; j < KT_TILE_MAX; ++j)
      if (j < nt) acc[j] |= x & tile[((size_t)j * K + k) * W + w];
  }
}

// Rows of the other side per block: up to KT_TILE_MAX within the default
// 48 KB of shared memory, else one row (a row above the block's 227 KB makes
// the shared-memory opt-in below fail, and the launcher returns that error).
__host__ inline int kt_tile(int K, int W, int rows) {
  const size_t row_bytes = (size_t)K * W * sizeof(uint32_t);
  size_t tile = row_bytes ? (48 * 1024) / row_bytes : KT_TILE_MAX;
  if (tile > KT_TILE_MAX) tile = KT_TILE_MAX;
  if (tile > (size_t)rows) tile = rows;
  return tile < 1 ? 1 : (int)tile;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
__host__ inline cudaError_t kt_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
