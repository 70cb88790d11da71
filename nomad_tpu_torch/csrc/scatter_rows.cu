// Row scatter of the usage mirror's device copy (sm_90a, plain C ABI).
//
// Replaces nomad_tpu/models/fleet.py _scatter_jit_impl (K5,
// ``usage.at[idx].set(rows)``), launched from _scatter_rows after every
// mirror sync that touched at most MAX_SCATTER_ROWS rows.
//
// Bound on an H100: bytes.  It moves R*D floats in and R ints of
// indices, at most 1,024 x 6 values, a few tens of kilobytes, so the
// launch itself is the cost.  One thread writes one value; the
// wrapper has already copied the old buffer into the new one (the old
// buffer is never modified: in-flight dispatches still read it).  Pad
// entries repeat idx[0] with its own row, so duplicates write the same
// value and the order of the writes does not matter.  Out-of-range
// indices are skipped here and rejected by the wrapper on the host.
#include <cuda_runtime.h>

__global__ void scatter_rows_kernel(float* __restrict__ out,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ rows, int r,
                                    int n, int d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= r * d) return;
  const int i = idx[t / d];
  if (i < 0 || i >= n) return;
  out[(size_t)i * d + t % d] = rows[t];
}

extern "C" {

const char* nomad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int nomad_scatter_rows(float* out, const int* idx, const float* rows, int r,
                       int n, int d, void* stream) {
  if (r <= 0) return 0;
  const int threads = 256;
  const int blocks = (r * d + threads - 1) / threads;
  scatter_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      out, idx, rows, r, n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
