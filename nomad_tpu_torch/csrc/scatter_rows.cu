// Row scatter of the usage mirror's device copy (sm_90a, plain C ABI).
//
// Replaces nomad_tpu/models/fleet.py _scatter_jit_impl (K5,
// ``usage.at[idx].set(rows)``), launched from _scatter_rows after every
// mirror sync that touched at most MAX_SCATTER_ROWS rows.
//
// Bound on an H100: bytes.  The function reads the old buffer and
// writes a new one (2 x N x D floats, ~0.8 MB at N = 16,384) plus R x D
// replacement floats and R indices, a fraction of a microsecond at
// 3.35 TB/s, so the cost is the launch.  The design is ONE launch that
// writes the whole new buffer: each block owns a contiguous range of
// rows, copies them from the old buffer with 16-byte loads and stores
// where alignment allows, then (after __syncthreads) writes the
// replacement rows whose index falls in its range, reading the indices
// in chunks through shared memory.  Blocks own disjoint rows, so no
// ordering across blocks is needed.  The old buffer is never written
// (in-flight dispatches and the verify engine's lease still read it).
// Pad entries repeat idx[0] with its own row, so duplicates write the
// same value and the order of the writes does not matter.  Out-of-range
// indices are skipped here and rejected by the wrapper on the host.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define IDX_CHUNK 1024     // indices staged in shared memory at a time
#define ROWS_MIN 128       // rows a block owns at least (an even count)
#define BLOCKS_MAX 528     // four blocks per SM of an H100

__global__ void __launch_bounds__(THREADS) scatter_rows_kernel(
    const float* __restrict__ usage, float* __restrict__ out,
    const int* __restrict__ idx, const float* __restrict__ rows, int r,
    int n, int d, int rows_per_block, bool vec) {
  __shared__ int s_idx[IDX_CHUNK];
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(n, row0 + rows_per_block);
  if (row0 >= row1) return;  // uniform across the block
  const size_t e0 = (size_t)row0 * d;
  const size_t e1 = (size_t)row1 * d;
  size_t e = e0;
  if (vec) {  // e0 is a multiple of 4 and both buffers 16-byte aligned
    const float4* src = reinterpret_cast<const float4*>(usage + e0);
    float4* dst = reinterpret_cast<float4*>(out + e0);
    const size_t n4 = (e1 - e0) / 4;
    for (size_t k = threadIdx.x; k < n4; k += THREADS) dst[k] = src[k];
    e = e0 + n4 * 4;
  }
  for (size_t k = e + threadIdx.x; k < e1; k += THREADS) out[k] = usage[k];
  for (int c0 = 0; c0 < r; c0 += IDX_CHUNK) {
    const int len = min(IDX_CHUNK, r - c0);
    // Orders this block's copy before its scatter and the previous
    // chunk's reads of s_idx before this chunk's writes.
    __syncthreads();
    for (int t = threadIdx.x; t < len; t += THREADS) s_idx[t] = idx[c0 + t];
    __syncthreads();
    for (int t = threadIdx.x; t < len * d; t += THREADS) {
      const int j = t / d;
      const int i = s_idx[j];
      if (i >= row0 && i < row1) {
        const int c = t - j * d;
        out[(size_t)i * d + c] = rows[(size_t)(c0 + j) * d + c];
      }
    }
  }
}

extern "C" {

const char* nomad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out = usage with rows idx[0..r) replaced by rows[0..r); usage f32[n, d]
// is only read.
int nomad_scatter_rows(const float* usage, float* out, const int* idx,
                       const float* rows, int r, int n, int d, void* stream) {
  if (n < 1 || d < 1 || r < 0) return (int)cudaErrorInvalidValue;
  int rows_per_block = (n + BLOCKS_MAX - 1) / BLOCKS_MAX;
  if (rows_per_block < ROWS_MIN) rows_per_block = ROWS_MIN;
  rows_per_block += rows_per_block & 1;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  // 16-byte copies need every block's first element on a 4-float
  // boundary (rows_per_block is even, so an even d gives it).
  const bool vec = (((uintptr_t)usage | (uintptr_t)out) & 15) == 0 &&
                   ((size_t)rows_per_block * d) % 4 == 0;
  scatter_rows_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      usage, out, idx, rows, r, n, d, rows_per_block, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
