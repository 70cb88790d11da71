// Placement kernels for the torch-binpack scheduler (sm_90a, plain C ABI).
//
// Replaces nomad_tpu/ops/binpack.py:
//   score_all_nodes  (K1)  -> score_node, a __device__ routine fused into
//                             both kernels below;
//   _place_sequence  (K2)  -> place_sequence_kernel;
//   _place_rounds    (K3)  -> place_rounds_kernel;
//   place_rounds_batch    (K4a, a vmap of K3) -> place_rounds_batch_kernel;
//   place_sequence_batch  (K4b, a vmap of K2) -> place_sequence_batch_kernel.
//
// One code path: the body of each placement walk is a __device__
// function over one lane's pointers (place_sequence_lane,
// place_rounds_lane).  The single-eval kernels run it in one block; the
// batch kernels run one block per lane (blockIdx.x = lane), each lane
// reading its own slices of the per-lane operands and the SHARED
// capacity / reserved / usage0, and evolving its own copy of the usage
// in its slice of the f32[B, N, D] output.  So K2/K3 and K4 cannot
// drift apart.
//
// Bound on an H100: the work per dispatch is tiny next to the card
// (K2 at N = 16,384 nodes and P = 1,024 placements is ~5e8 fp32
// operations and ~1.5 MB of distinct input, a few microseconds at
// 67 TFLOP/s or 3.35 TB/s).  What bounds these kernels is the chain of
// dependent steps: placement p+1 scores against the usage that
// placement p wrote, and a top-k round waits on the round before it.
// The design takes that chain as given: ONE persistent block of 1,024
// threads walks every step of a dispatch (no launch per step, no host
// round trip), keeps the running usage and job counts in its own
// output buffers (the input usage may be the usage mirror's resident
// copy, which must stay unchanged), and synchronises with
// __syncthreads between steps.  The node tensors (~1.2 MB at 16,384
// nodes) stay resident in L2 across steps.  Spreading one dispatch
// over many SMs needs a grid-wide barrier per step; that is later work.
//
// Numerics: every operation is IEEE fp32 in the reference's order, with
// explicit _rn intrinsics, powf (no fast math) and -fmad=false, so the
// scores equal the plain PyTorch version's on the card and the argmax
// and top-k pick the same nodes.
#include <cuda_runtime.h>
#include <stdint.h>

#define NDIMS 6
#define THREADS 1024
#define NEG_INF (-1.0e30f)
#define SMEM_SORT_MAX 16384  // keys sorted in shared memory up to this N

// K1: masked score of one ask on node i (nomad_tpu/ops/binpack.py
// score_all_nodes): AllocsFit over all dims, ScoreFit v3, job
// anti-affinity, distinct_hosts, -1e30 where infeasible.
__device__ __forceinline__ float score_node(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* usage, const int* jc, const float* ask,
    const uint8_t* __restrict__ feas, bool distinct, float penalty, int i) {
  const float* c = cap + (size_t)i * NDIMS;
  const float* r = res + (size_t)i * NDIMS;
  const float* u = usage + (size_t)i * NDIMS;
  bool fit = true;
  float util[NDIMS];
#pragma unroll
  for (int d = 0; d < NDIMS; ++d) {
    util[d] = __fadd_rn(__fadd_rn(r[d], u[d]), ask[d]);
    fit = fit && (util[d] <= c[d]);
  }
  const float node_cpu = __fsub_rn(c[0], r[0]);
  const float node_mem = __fsub_rn(c[1], r[1]);
  const float safe_cpu = node_cpu > 0.0f ? node_cpu : 1.0f;
  const float safe_mem = node_mem > 0.0f ? node_mem : 1.0f;
  const float free_cpu = __fsub_rn(1.0f, __fdiv_rn(util[0], safe_cpu));
  const float free_mem = __fsub_rn(1.0f, __fdiv_rn(util[1], safe_mem));
  float score = __fsub_rn(
      20.0f, __fadd_rn(powf(10.0f, free_cpu), powf(10.0f, free_mem)));
  score = score < 0.0f ? 0.0f : (score > 18.0f ? 18.0f : score);
  if (!(node_cpu > 0.0f && node_mem > 0.0f)) score = 0.0f;
  const int j = jc[i];
  score = __fsub_rn(score, __fmul_rn(penalty, (float)j));
  const bool ok = feas[i] && fit && (!distinct || j == 0);
  return ok ? score : NEG_INF;
}

// (score, index) order of the argmax: higher score first, then lower
// index (jnp.argmax returns the first maximum).
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void copy_state(
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    float* usage, int* jc, int n) {
  for (int i = threadIdx.x; i < n * NDIMS; i += THREADS) usage[i] = usage0[i];
  for (int i = threadIdx.x; i < n; i += THREADS) jc[i] = jc0[i];
}

// K2 body: one placement per step, P steps in one block, for one lane.
__device__ __forceinline__ void place_sequence_lane(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ group_idx,
    const uint8_t* __restrict__ valid, float penalty, int n, int p_len,
    int* __restrict__ chosen, float* __restrict__ scores, float* usage,
    int* jc) {
  __shared__ float s_ask[NDIMS];
  __shared__ float s_val[THREADS / 32];
  __shared__ int s_idx[THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  copy_state(usage0, jc0, usage, jc, n);
  __syncthreads();
  for (int p = 0; p < p_len; ++p) {
    if (!valid[p]) {  // uniform across the block
      if (tid == 0) {
        chosen[p] = -1;
        scores[p] = NEG_INF;
      }
      continue;
    }
    const int g = group_idx[p];
    if (tid < NDIMS) s_ask[tid] = asks[g * NDIMS + tid];
    __syncthreads();
    const uint8_t* feas_g = feas + (size_t)g * n;
    const bool dist = distinct[g] != 0;
    float best = __int_as_float(0xff800000);  // -inf
    int bi = 0x7fffffff;
    for (int i = tid; i < n; i += THREADS) {
      const float s =
          score_node(cap, res, usage, jc, s_ask, feas_g, dist, penalty, i);
      if (s > best) {  // strided walk: the first max per thread is lowest
        best = s;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_val[lane];
      bi = s_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, best, bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        const bool ok = best > NEG_INF / 2;
        chosen[p] = ok ? bi : -1;
        scores[p] = best;
        if (ok) {
#pragma unroll
          for (int d = 0; d < NDIMS; ++d)
            usage[(size_t)bi * NDIMS + d] =
                __fadd_rn(usage[(size_t)bi * NDIMS + d], s_ask[d]);
          jc[bi] += 1;
        }
      }
    }
    __syncthreads();
  }
}

// Order-preserving map of an fp32 score to 32 bits (IEEE-754 as a
// sign-flipped integer); -0.0 is folded into +0.0 so the two tie.
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Block-wide bitonic sort of n (a power of two) keys, descending.
__device__ void bitonic_sort_desc(unsigned long long* keys, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += THREADS) {
        const int a = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int b = a + j;
        const bool desc = (a & k) == 0;
        const unsigned long long ka = keys[a];
        const unsigned long long kb = keys[b];
        if ((ka < kb) == desc) {
          keys[a] = kb;
          keys[b] = ka;
        }
      }
      __syncthreads();
    }
  }
}

// K3: for each slot, `rounds` rounds of score -> top-k_cap -> place at
// up to min(remaining, k_cap) distinct winners.  The top-k is a full
// sort of 64-bit keys (ordered score bits, inverted node index), so it
// returns the k largest with ties to the lower index, as lax.top_k.
__device__ __forceinline__ void place_rounds_lane(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ counts,
    float penalty, int n, int g_len, int k_cap, int rounds,
    int* __restrict__ chosen, float* __restrict__ scores, float* usage,
    int* jc, unsigned long long* keys) {
  __shared__ float s_ask[NDIMS];
  const int tid = threadIdx.x;
  const size_t stream_len = (size_t)rounds * k_cap;
  copy_state(usage0, jc0, usage, jc, n);
  __syncthreads();
  for (int s = 0; s < g_len; ++s) {
    if (tid < NDIMS) s_ask[tid] = asks[(size_t)s * NDIMS + tid];
    __syncthreads();
    const uint8_t* feas_s = feas + (size_t)s * n;
    const bool dist = distinct[s] != 0;
    int m = counts[s];
    for (int r = 0; r < rounds; ++r) {
      int* out_c = chosen + (size_t)s * stream_len + (size_t)r * k_cap;
      float* out_s = scores + (size_t)s * stream_len + (size_t)r * k_cap;
      if (m <= 0) {  // uniform across the block: nothing left to place
        for (int pos = tid; pos < k_cap; pos += THREADS) {
          out_c[pos] = -1;
          out_s[pos] = NEG_INF;
        }
        continue;
      }
      for (int i = tid; i < n; i += THREADS) {
        const float v =
            score_node(cap, res, usage, jc, s_ask, feas_s, dist, penalty, i);
        keys[i] = ((unsigned long long)ordered_bits(v) << 32) |
                  (unsigned long long)(~(uint32_t)i);
      }
      __syncthreads();
      bitonic_sort_desc(keys, n);
      int placed = 0;
      for (int base = 0; base < k_cap; base += THREADS) {
        const int pos = base + tid;
        bool take = false;
        if (pos < k_cap) {
          const unsigned long long key = keys[pos];
          const int idx = (int)(~(uint32_t)(key & 0xffffffffull));
          const float val = from_ordered((uint32_t)(key >> 32));
          take = pos < m && val > NEG_INF / 2;
          out_c[pos] = take ? idx : -1;
          out_s[pos] = val;
          if (take) {  // winners are distinct: no two threads share a row
#pragma unroll
            for (int d = 0; d < NDIMS; ++d)
              usage[(size_t)idx * NDIMS + d] =
                  __fadd_rn(usage[(size_t)idx * NDIMS + d], s_ask[d]);
            jc[idx] += 1;
          }
        }
        placed += __syncthreads_count(take);
      }
      m -= placed;
    }
    __syncthreads();
  }
}


// The four kernels.  Sort keys of N <= SMEM_SORT_MAX nodes live in the
// block's dynamic shared memory; above that, in the caller's scratch
// (one row of N keys per lane).
__global__ void __launch_bounds__(THREADS) place_sequence_kernel(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ group_idx,
    const uint8_t* __restrict__ valid, float penalty, int n, int p_len,
    int* __restrict__ chosen, float* __restrict__ scores, float* usage,
    int* jc) {
  place_sequence_lane(cap, res, usage0, jc0, feas, asks, distinct, group_idx,
                      valid, penalty, n, p_len, chosen, scores, usage, jc);
}

__global__ void __launch_bounds__(THREADS) place_rounds_kernel(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ counts,
    float penalty, int n, int g_len, int k_cap, int rounds,
    int* __restrict__ chosen, float* __restrict__ scores, float* usage,
    int* jc, unsigned long long* scratch) {
  extern __shared__ unsigned long long s_keys[];
  place_rounds_lane(cap, res, usage0, jc0, feas, asks, distinct, counts,
                    penalty, n, g_len, k_cap, rounds, chosen, scores, usage,
                    jc, scratch != nullptr ? scratch : s_keys);
}

// K4b (nomad_tpu/ops/binpack.py place_sequence_batch): K2 over B lanes,
// one block per lane.
//
// Bound on an H100: at B = 8 lanes, N = 16,384, P = 256 the work is
// ~1.1e9 fp32 operations over ~2 MB of distinct input, ~16 us at
// 67 TFLOP/s.  What bounds it is each lane's chain of P dependent steps
// (K2's ~18 us a step on one SM); the lanes run side by side on their
// own SMs, so B <= 132 lanes take about the time of one.
__global__ void __launch_bounds__(THREADS) place_sequence_batch_kernel(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ group_idx,
    const uint8_t* __restrict__ valid, const float* __restrict__ penalty,
    int n, int g_len, int p_len, int* __restrict__ chosen,
    float* __restrict__ scores, float* usage, int* jc) {
  const size_t b = blockIdx.x;
  const size_t nn = (size_t)n;
  place_sequence_lane(
      cap, res, usage0, jc0 + b * nn, feas + b * (size_t)g_len * nn,
      asks + b * (size_t)g_len * NDIMS, distinct + b * (size_t)g_len,
      group_idx + b * (size_t)p_len, valid + b * (size_t)p_len, penalty[b],
      n, p_len, chosen + b * (size_t)p_len, scores + b * (size_t)p_len,
      usage + b * nn * NDIMS, jc + b * nn);
}

// K4a (nomad_tpu/ops/binpack.py place_rounds_batch): K3 over B lanes,
// one block per lane.
//
// Bound on an H100: config 5 (B = 64 lanes, N = 16,384, one slot of
// 1,000 copies, one round) reads ~1.5 MB of shared fleet tensors and
// 1 MB of per-lane feasibility and writes 25 MB of per-lane usage:
// ~8 us at 3.35 TB/s, bytes-bound.  K3's sort of 16,384 keys in one
// block dominates each lane; the design runs the 64 lanes' sorts side
// by side, one block with 128 KB of shared memory per SM, so the storm
// costs about one K3 launch instead of 64.
__global__ void __launch_bounds__(THREADS) place_rounds_batch_kernel(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ counts,
    const float* __restrict__ penalty, int n, int g_len, int k_cap,
    int rounds, int* __restrict__ chosen, float* __restrict__ scores,
    float* usage, int* jc, unsigned long long* scratch) {
  extern __shared__ unsigned long long s_keys[];
  const size_t b = blockIdx.x;
  const size_t nn = (size_t)n;
  const size_t stream = (size_t)g_len * rounds * k_cap;
  place_rounds_lane(
      cap, res, usage0, jc0 + b * nn, feas + b * (size_t)g_len * nn,
      asks + b * (size_t)g_len * NDIMS, distinct + b * (size_t)g_len,
      counts + b * (size_t)g_len, penalty[b], n, g_len, k_cap, rounds,
      chosen + b * stream, scores + b * stream, usage + b * nn * NDIMS,
      jc + b * nn, scratch != nullptr ? scratch + b * nn : s_keys);
}

// Dynamic shared memory for the sort of one block's keys: n keys when
// they fit (and the attribute raised past 48 KB), 0 when the caller
// passed a scratch buffer.  Returns a CUDA error code.
template <typename Kernel>
static int sort_smem(Kernel kernel, int n, const void* scratch,
                     size_t* smem) {
  *smem = 0;
  if (scratch != nullptr) return 0;
  if (n > SMEM_SORT_MAX) return (int)cudaErrorInvalidValue;
  *smem = (size_t)n * sizeof(unsigned long long);
  if (*smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  }
  return 0;
}

extern "C" {

const char* nomad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int nomad_place_sequence(const float* cap, const float* res,
                         const float* usage0, const int* jc0,
                         const uint8_t* feas, const float* asks,
                         const uint8_t* distinct, const int* group_idx,
                         const uint8_t* valid, float penalty, int n, int p_len,
                         int* chosen, float* scores, float* usage, int* jc,
                         void* stream) {
  place_sequence_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      cap, res, usage0, jc0, feas, asks, distinct, group_idx, valid, penalty,
      n, p_len, chosen, scores, usage, jc);
  return (int)cudaGetLastError();
}

int nomad_place_rounds(const float* cap, const float* res, const float* usage0,
                       const int* jc0, const uint8_t* feas, const float* asks,
                       const uint8_t* distinct, const int* counts,
                       float penalty, int n, int g_len, int k_cap, int rounds,
                       int* chosen, float* scores, float* usage, int* jc,
                       unsigned long long* scratch, void* stream) {
  size_t smem = 0;
  const int e = sort_smem(place_rounds_kernel, n, scratch, &smem);
  if (e != 0) return e;
  place_rounds_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      cap, res, usage0, jc0, feas, asks, distinct, counts, penalty, n, g_len,
      k_cap, rounds, chosen, scores, usage, jc, scratch);
  return (int)cudaGetLastError();
}

int nomad_place_sequence_batch(
    const float* cap, const float* res, const float* usage0, const int* jc0,
    const uint8_t* feas, const float* asks, const uint8_t* distinct,
    const int* group_idx, const uint8_t* valid, const float* penalty,
    int lanes, int n, int g_len, int p_len, int* chosen, float* scores,
    float* usage, int* jc, void* stream) {
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  place_sequence_batch_kernel<<<lanes, THREADS, 0, (cudaStream_t)stream>>>(
      cap, res, usage0, jc0, feas, asks, distinct, group_idx, valid, penalty,
      n, g_len, p_len, chosen, scores, usage, jc);
  return (int)cudaGetLastError();
}

int nomad_place_rounds_batch(
    const float* cap, const float* res, const float* usage0, const int* jc0,
    const uint8_t* feas, const float* asks, const uint8_t* distinct,
    const int* counts, const float* penalty, int lanes, int n, int g_len,
    int k_cap, int rounds, int* chosen, float* scores, float* usage, int* jc,
    unsigned long long* scratch, void* stream) {
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int e = sort_smem(place_rounds_batch_kernel, n, scratch, &smem);
  if (e != 0) return e;
  place_rounds_batch_kernel<<<lanes, THREADS, smem, (cudaStream_t)stream>>>(
      cap, res, usage0, jc0, feas, asks, distinct, counts, penalty, n, g_len,
      k_cap, rounds, chosen, scores, usage, jc, scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
