// Window verify of the group-commit applier (sm_90a, plain C ABI).
//
// Replaces nomad_tpu/parallel/mesh.py _window_verify_jit (K6): for every
// (plan, node) claim ("pair") of one verify window, the claim-scatter of
// its placement rows, the base fit against the resident fleet tensors,
// and the component-local overlay fold of the earlier plans' entries.
// Launched once per window by parallel/mesh.window_verify.
//
// Inputs: capacity/reserved/usage f32[N, D] row-major, resident on the
// card (only the D=6 rows the pairs claim are read, columns 0-3); one
// packed descriptor buffer of B-long arrays, B a power of two >= 8
// (every array padded to one shared bucket), laid out as int32
//   pair_ni | row_pair | seq_ni | seq_order | seq_comp | pair_order |
//   pair_comp | row_vec[B][4] | seq_vec[B][4] | pair_removed[B][4]
// with the three vector arrays holding float32 bits.  Outputs used and
// caps f32[B, 4] and fits bool[B].
//
//   used[p]  = (usage[ni] + reserved[ni]) + sum(row_vec[r], row_pair[r]==p)
//   caps[p]  = capacity[ni]
//   fits[p]  = all((used[p] + fold[p]) - pair_removed[p] <= caps[p])
//   fold[p]  = sum(seq_vec[s]) over the entries with seq_ni[s] == ni,
//              seq_order[s] < pair_order[p], seq_comp[s] == pair_comp[p]
//
// A padded fold entry has node -1 and never matches; a padded pair reads
// row 0 and the host slices it off; a padded placement row adds 0 to
// pair 0.  Every resource value is a small integer held in fp32, so each
// partial sum is exact below 2^24 and the order of the sums cannot change
// a bit.  The order is fixed all the same (below), so the kernel is
// deterministic, and every add is a full fp32 add (-fmad=false, no fast
// math).
//
// Bound on an H100: bytes at both windows, the gathered rows and the
// descriptors each read once.  At the fleet-scaling window (B = 64
// single-placement plans) they are a few kilobytes and the launch is the
// cost.  At a contended config-5b window (B = 8,192) the function needs
// only the adds of the fold entries that match a pair, but this kernel
// walks every (pair, fold entry), about 8 fp32 operations each: that
// walk, not the bound, sets its time.
// A block owns kPairs pairs with kSlices threads each (1,024 threads, so
// a config-5b window fills 128 SMs with 32 warps apiece to hide the
// shared-memory latency of the inner loop); the block streams the
// placement rows and fold entries through shared memory in tiles of
// 1,024 that all its threads load together, each entry read from device
// memory once per block.  Thread (pair, slice) sums every kSlices-th
// entry of each tile in registers; the kSlices partial sums of a pair
// are then added in slice order.  Sorting fold entries by node, or a
// cluster per window, is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 64;                  // pairs per block
constexpr int kSlices = 16;                 // threads per pair
constexpr int kThreads = kPairs * kSlices;  // = entries per tile

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

__global__ void __launch_bounds__(kThreads)
    window_verify_kernel(const float* __restrict__ capacity,
                         const float* __restrict__ reserved,
                         const float* __restrict__ usage, int d,
                         const int* __restrict__ desc, int b,
                         float* __restrict__ used_out,
                         float* __restrict__ caps_out,
                         unsigned char* __restrict__ fits_out) {
  const int* pair_ni = desc;
  const int* row_pair = desc + b;
  const int* seq_ni = desc + 2 * b;
  const int* seq_order = desc + 3 * b;
  const int* seq_comp = desc + 4 * b;
  const int* pair_order = desc + 5 * b;
  const int* pair_comp = desc + 6 * b;
  // 7 * b int32 = a multiple of 16 bytes for b >= 8: float4-aligned.
  const float4* row_vec = reinterpret_cast<const float4*>(desc + 7 * b);
  const float4* seq_vec = reinterpret_cast<const float4*>(desc + 11 * b);
  const float4* pair_removed =
      reinterpret_cast<const float4*>(desc + 15 * b);

  // One tile: (row_pair, seq_ni, seq_order, seq_comp) and the two
  // vectors of 1,024 entries, 48 KB.  The vector arrays hold the
  // partial sums after the last tile.
  __shared__ int4 s_key[kThreads];
  __shared__ float4 s_row_vec[kThreads];
  __shared__ float4 s_seq_vec[kThreads];

  const int lane = threadIdx.x % kPairs;
  const int slice = threadIdx.x / kPairs;  // two whole warps a slice
  const int p = blockIdx.x * kPairs + lane;
  const bool live = p < b;
  const int ni = live ? pair_ni[p] : -2;  // -2 matches no entry
  const int order = live ? pair_order[p] : 0;
  const int comp = live ? pair_comp[p] : 0;

  float4 delta = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 fold = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = 0; base < b; base += kThreads) {
    const int t = base + threadIdx.x;
    if (t < b) {
      s_key[threadIdx.x] =
          make_int4(row_pair[t], seq_ni[t], seq_order[t], seq_comp[t]);
      s_row_vec[threadIdx.x] = row_vec[t];
      s_seq_vec[threadIdx.x] = seq_vec[t];
    }
    __syncthreads();
    const int m = min(kThreads, b - base);
    for (int k = slice; k < m; k += kSlices) {
      const int4 key = s_key[k];
      if (key.x == p) add4(delta, s_row_vec[k]);
      if (key.y == ni && key.z < order && key.w == comp)
        add4(fold, s_seq_vec[k]);
    }
    __syncthreads();
  }
  s_row_vec[slice * kPairs + lane] = delta;
  s_seq_vec[slice * kPairs + lane] = fold;
  __syncthreads();
  if (slice != 0 || !live) return;
  delta = s_row_vec[lane];
  fold = s_seq_vec[lane];
  for (int s = 1; s < kSlices; ++s) {
    add4(delta, s_row_vec[s * kPairs + lane]);
    add4(fold, s_seq_vec[s * kPairs + lane]);
  }

  const size_t row = (size_t)ni * d;
  const float u[4] = {
      __fadd_rn(__fadd_rn(usage[row + 0], reserved[row + 0]), delta.x),
      __fadd_rn(__fadd_rn(usage[row + 1], reserved[row + 1]), delta.y),
      __fadd_rn(__fadd_rn(usage[row + 2], reserved[row + 2]), delta.z),
      __fadd_rn(__fadd_rn(usage[row + 3], reserved[row + 3]), delta.w)};
  const float f[4] = {fold.x, fold.y, fold.z, fold.w};
  const float4 rm = pair_removed[p];
  const float r[4] = {rm.x, rm.y, rm.z, rm.w};
  bool fits = true;
  for (int j = 0; j < 4; ++j) {
    const float cap = capacity[row + j];
    used_out[(size_t)p * 4 + j] = u[j];
    caps_out[(size_t)p * 4 + j] = cap;
    fits = fits && (__fsub_rn(__fadd_rn(u[j], f[j]), r[j]) <= cap);
  }
  fits_out[p] = fits ? 1 : 0;
}

}  // namespace

extern "C" {

const char* nomad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int nomad_window_verify(const float* capacity, const float* reserved,
                        const float* usage, int d, const int* desc, int b,
                        float* used, float* caps, unsigned char* fits,
                        void* stream) {
  if (b <= 0) return 0;
  const int blocks = (b + kPairs - 1) / kPairs;
  window_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      capacity, reserved, usage, d, desc, b, used, caps, fits);
  return (int)cudaGetLastError();
}

}  // extern "C"
