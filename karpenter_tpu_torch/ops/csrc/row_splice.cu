// B3 row_splice: write one dirty row span of every exist-side leaf into the
// resident device buffers, in place.
//
// Replaces karpenter_tpu/parallel/mesh.py _donated_row_splice (lines 264-266):
// a jitted dynamic_update_slice with its buffer donated, which the mesh
// placer calls once for each of the 7 exist-side leaves of a dirty shard
// span (mesh.py:370-375), each after a device_put of its own. Here the
// wrapper (ops/kernels.py row_splice) writes the span of all leaves back to
// back into one pinned staging buffer, copies it to the device once, and
// this kernel copies every leaf's bytes from the staging tensor into its
// buffer in one launch. In row-major storage a leaf's row span is one
// contiguous byte range, so the work is a batched contiguous copy described
// by a table of (destination, source, byte count).
//
// Bound: bytes. A span of 2,048 rows at K = 9, W = 64, R = 4 (2,419 bytes a
// row) is 4.95 MB read and 4.95 MB written: 3.0 us at 3.35 TB/s.
//
// Design: blockIdx.y picks the table entry and the blocks along x stride
// over its bytes. Where destination and source agree modulo 16 (the wrapper
// puts every source at a 16-byte offset of the staging tensor and the
// resident buffers are allocator-aligned, so a span starting at a row whose
// byte offset is a multiple of 16 always does), a byte head brings the
// destination to 16-byte alignment and the body moves 16 bytes a thread;
// the rest, and a whole leaf whose ends disagree (a bool leaf of 9 bytes a
// row starting at an odd row), goes byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

#define KT_SPLICE_MAX 16

struct SpliceTable {
  unsigned long long dst[KT_SPLICE_MAX];
  unsigned long long src[KT_SPLICE_MAX];
  unsigned long long bytes[KT_SPLICE_MAX];
};

__global__ void row_splice_kernel(SpliceTable table) {
  const int e = blockIdx.y;
  unsigned char* dst = (unsigned char*)table.dst[e];
  const unsigned char* src = (const unsigned char*)table.src[e];
  const size_t n = (size_t)table.bytes[e];
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t head = 0, body = 0;  // body counts 16-byte words
  if ((((uintptr_t)dst ^ (uintptr_t)src) & 15) == 0) {
    head = (16 - ((uintptr_t)dst & 15)) & 15;
    if (head > n) head = n;
    body = (n - head) / 16;
  }
  for (size_t i = tid; i < head; i += stride) dst[i] = src[i];
  uint4* dv = (uint4*)(dst + head);
  const uint4* sv = (const uint4*)(src + head);
  for (size_t i = tid; i < body; i += stride) dv[i] = sv[i];
  for (size_t i = head + body * 16 + tid; i < n; i += stride) dst[i] = src[i];
}

// dst, src and bytes are host arrays of n device addresses and byte counts.
extern "C" int kt_row_splice(const unsigned long long* dst,
                             const unsigned long long* src,
                             const unsigned long long* bytes, int n,
                             void* stream) {
  if (n < 1 || n > KT_SPLICE_MAX) return (int)cudaErrorInvalidValue;
  SpliceTable table;
  unsigned long long most = 0;
  for (int i = 0; i < KT_SPLICE_MAX; ++i) {
    table.dst[i] = i < n ? dst[i] : 0ull;
    table.src[i] = i < n ? src[i] : 0ull;
    table.bytes[i] = i < n ? bytes[i] : 0ull;
    if (table.bytes[i] > most) most = table.bytes[i];
  }
  const int threads = 256;
  const unsigned long long per_block = (unsigned long long)threads * 16ull;
  unsigned long long bx = (most + per_block - 1) / per_block;
  if (bx < 1) bx = 1;
  if (bx > 1024) bx = 1024;
  dim3 grid((unsigned)bx, (unsigned)n);
  row_splice_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(table);
  return (int)cudaGetLastError();
}
