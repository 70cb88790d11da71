// Placement kernels for the torch-binpack scheduler (sm_90a, plain C ABI).
//
// Replaces nomad_tpu/ops/binpack.py:
//   score_all_nodes  (K1)  -> score_values / score_node, __device__
//                             routines fused into every kernel below;
//   _place_sequence  (K2)  -> place_sequence_kernel, a thread-block
//                             cluster walking place_sequence_cluster_lane;
//   _place_rounds    (K3)  -> place_rounds_kernel;
//   place_rounds_batch    (K4a, a vmap of K3) -> place_rounds_batch_kernel;
//   place_sequence_batch  (K4b, a vmap of K2) -> place_sequence_batch_kernel;
// and the three kernels of the node-axis-sharded walks that replace
// nomad_tpu/parallel/mesh.py _place_sharded, _place_rounds_sharded_jit,
// _place_rounds_batch_sharded_jit and _place_sequence_batch_sharded_jit
// (K7; see the section "K7" below): shard_walk_kernel (a whole sharded
// walk on one card, one launch), and for rows whose shards span cards
// shard_step_kernel (K7a+c, the per-shard half of a step) and
// merge_select_kernel (K7b).
//
// One body for the sequence walk: K2 runs place_sequence_cluster_lane
// (below) on one thread-block cluster, K4b on one cluster per lane (its
// lanes are held against K2 bit for bit).  K3 and K4a share
// place_rounds_lane, one block per lane.  Each body is a
// __device__ function over one lane's pointers: the batch kernels read
// their lane's slices of the per-lane operands and the SHARED capacity
// / reserved / usage0, and evolve their own copy of the usage in their
// slice of the f32[B, N, D] output.  No kernel writes its input usage
// (it may be the usage mirror's resident copy).
//
// Bound on an H100: the work per dispatch is tiny next to the card
// (K2 at N = 16,384 nodes and P = 1,024 placements needs one scoring of
// the fleet per group change and one node per placement: a few 1e7
// fp32 operations over ~1.5 MB of distinct input).  What bounds these
// kernels is the chain of dependent steps: placement p+1 scores against
// the usage that placement p wrote, and a top-k round waits on the
// round before it.  The walks take that chain as given and keep every
// step on the card (no launch per step, no host round trip).  K2 and
// each K4b lane spread the nodes of one walk over a cluster of up to 16
// SMs that keeps a score slot per group current, so a placement
// rescores one node; K3 and K4a's lanes are one persistent block of
// 1,024 threads each, synchronised with __syncthreads between steps.
//
// K3/K4a's top-k: a round needs only the k_cap best of N scores, so where
// k_cap < N / 2 the lane does a most-significant-digit radix select of the
// k_cap-th largest 32-bit key (a digit of 8 bits a pass, warp-aggregated
// histograms), gathers the keys above it and the lowest-indexed keys equal
// to it in node order, and sorts only those k_cap: ~4 passes over N words
// and a sort of k_cap keys, where a full sort of N 64-bit keys took
// log2(N)(log2(N)+1)/2 block-wide stages (105 at N = 16,384).  Keys are
// one 32-bit word a node (the index is the word's position), so a lane's
// key region is half of what the full sort needs.  No matrix product is
// involved: tensor cores do not apply.
//
// Where nothing is placed (an invalid step, a group no node fits, a
// round entered with no copies left) the walks still score and write
// the best score, and add +0.0 to the rows the JAX scan adds zero to,
// so a -0.0 usage entry comes out as +0.0 exactly as in the reference.
//
// Numerics: every operation is IEEE fp32 in the reference's order, with
// explicit _rn intrinsics, powf (no fast math) and -fmad=false, so the
// scores equal the plain PyTorch version's on the card and the argmax
// and top-k pick the same nodes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NDIMS 6
#define THREADS 1024
#define WARPS (THREADS / 32)
#define NEG_INF (-1.0e30f)
#define FULL_MASK 0xffffffffu
#define KEYS_SMEM_MAX (128 * 1024)  // a K3/K4a lane's keys in shared memory
                                    // up to this many bytes, else scratch
#define RADIX_BINS 256       // K3/K4a's select: digits of 8 bits
#define MAX_CLUSTER 16       // CTAs of one K2 cluster (non-portable above 8)
#define MAX_SLOTS WARPS      // score slots of one K2 CTA (a warp keeps each)
#define STEP_CHUNK 1024      // K2 steps staged in shared memory at a time
#define CACHE_SMEM_MAX (188 * 1024)  // K2's dynamic shared memory, bytes

// Where a K2 CTA keeps its node state and score slots.
#define SEQ_SHARED 0   // in shared memory
#define SEQ_SCRATCH 1  // in device memory (the slots in the scratch)

// How a K3/K4a round finds its top k_cap (see topk_path).
#define TOPK_SORT 0    // a full sort of N 64-bit keys
#define TOPK_SELECT 1  // a radix select on N 32-bit keys, then a sort of k_cap

// K1: masked score of one ask on a node with capacity c, reserved r,
// usage u and job count j (nomad_tpu/ops/binpack.py score_all_nodes):
// AllocsFit over all dims, ScoreFit v3, job anti-affinity,
// distinct_hosts, -1e30 where infeasible.
__device__ __forceinline__ float score_values(
    const float* c, const float* r, const float* u, int j, const float* ask,
    bool feasible, bool distinct, float penalty) {
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
  score = __fsub_rn(score, __fmul_rn(penalty, (float)j));
  const bool ok = feasible && fit && (!distinct || j == 0);
  return ok ? score : NEG_INF;
}

// K1 on node i of the fleet tensors.
__device__ __forceinline__ float score_node(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* usage, const int* jc, const float* ask,
    const uint8_t* __restrict__ feas, bool distinct, float penalty, int i) {
  return score_values(cap + (size_t)i * NDIMS, res + (size_t)i * NDIMS,
                      usage + (size_t)i * NDIMS, jc[i], ask, feas[i] != 0,
                      distinct, penalty);
}

// (score, index) order of the argmax: higher score first, then lower
// index (jnp.argmax returns the first maximum).
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Order-preserving map of an fp32 score to 32 bits (IEEE-754 as a
// sign-flipped integer); -0.0 is folded into +0.0 so the two tie.
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Argmax over the 32 lanes of a warp in the order of `better`; every
// lane gets the result.  Two warp reductions (the largest ordered score,
// then the lowest index holding it) and one shuffle for the score.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  const uint32_t key = ordered_bits(v);
  const uint32_t kmax = __reduce_max_sync(0xffffffffu, key);
  const int imin = __reduce_min_sync(0xffffffffu, key == kmax ? i : 0x7fffffff);
  const int src =
      __ffs(__ballot_sync(0xffffffffu, key == kmax && i == imin)) - 1;
  v = __shfl_sync(0xffffffffu, v, src);
  i = imin;
}

// Argmax over the block of each thread's (v, i); the result is in every
// lane of warp `lead`, and each warp's best in s_v/s_i (WARPS entries).
// Holds one __syncthreads.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* s_v,
                                             int* s_i, int lead = 0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  if (warp == lead) {
    v = s_v[lane];
    i = s_i[lane];
    warp_argmax(v, i);
  }
}

// The argmax row's update after a step: + ask where the step placed,
// + ask * 0.0 where it did not (the reference adds ask * delta).
__device__ __forceinline__ void add_step(float* u, const float* ask,
                                         bool ok) {
#pragma unroll
  for (int d = 0; d < NDIMS; ++d)
    u[d] = __fadd_rn(u[d], ok ? ask[d] : __fmul_rn(ask[d], 0.0f));
}

// Copy `count` 4-byte words with the block: 16 bytes a load and four
// loads in flight a thread where both ends are 16-byte aligned and count
// is a multiple of 4 (one block streams the whole copy, so it is the
// loads in flight that set its rate), else a word at a time.
__device__ __forceinline__ void copy_words(const void* __restrict__ src,
                                           void* __restrict__ dst,
                                           size_t count) {
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
      (count & 3) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const size_t v = count >> 2;
    size_t i = threadIdx.x;
    for (; i + 3 * THREADS < v; i += 4 * THREADS) {
      const uint4 a = s[i], b = s[i + THREADS], c = s[i + 2 * THREADS],
                  e = s[i + 3 * THREADS];
      d[i] = a;
      d[i + THREADS] = b;
      d[i + 2 * THREADS] = c;
      d[i + 3 * THREADS] = e;
    }
    for (; i < v; i += THREADS) d[i] = s[i];
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (size_t i = threadIdx.x; i < count; i += THREADS) d[i] = s[i];
  }
}

__device__ __forceinline__ void copy_state(
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    float* usage, int* jc, int n) {
  copy_words(usage0, usage, (size_t)n * NDIMS);
  copy_words(jc0, jc, (size_t)n);
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same shared-memory variable in CTA `rank` of the
// cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// Transaction mbarriers (one arrival, bytes from other CTAs' st.async).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of `bar` with this parity to complete.  A phase
// that has not completed after ~2^31 cycles (a second or more) means the
// exchange lost a message: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 31)) __trap();
  }
}

// 8 bytes into another CTA's shared memory (both addresses from
// cluster_addr), counted on its mbarrier.
__device__ __forceinline__ void send_pair(uint32_t to, uint32_t bar,
                                          uint32_t a, uint32_t b) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(to),
      "r"(a), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Write `len` steps' results staged in shared memory from step `p0` on.
__device__ __forceinline__ void flush_steps(int* chosen, float* scores,
                                            const int* s_chosen,
                                            const float* s_scores, int p0,
                                            int len) {
  for (int i = threadIdx.x; i < len; i += THREADS) {
    chosen[p0 + i] = s_chosen[i];
    scores[p0 + i] = s_scores[i];
  }
}

// Barrier among the first `warps` warps of the block (named barrier 1).
__device__ __forceinline__ void warps_sync(int warps) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(warps * 32) : "memory");
}

// K2 body on a cluster: one placement per step, P steps, for one lane.
//
// CTA `rank` of `csize` owns nodes [rank * npc, (rank + 1) * npc), npc =
// n / csize, thread t the local nodes t, t + THREADS, ... for a full
// scoring, and keeps per score slot s:
//
//   sc[s][npc]    masked scores of its nodes for the slot's group (one
//                 slot per group when `slots` = G, else one slot for the
//                 group of the last step), with the feasibility bytes
//                 beside them in shared memory;
//   s_wv/s_wi[s]  the best (score, index) of each warp's nodes;
//   s_slot_*[s]   the slot's group and the CTA's best (score, index).
//
// Node state and slots lie in shared memory (SEQ_SHARED) or, when they
// do not fit, in device memory (SEQ_SCRATCH); the steps' groups and valid
// flags, the steps' results and (G <= MAX_SLOTS) the asks and distinct
// flags are staged in shared memory, STEP_CHUNK steps at a time.
//
// A slot is scored in full by the whole CTA the first time its group
// is asked for (and, with one slot, at every group change).  From then
// on it stays current: warp s maintains slot s (warp 0 the one slot),
// and only these `slots` maintainer warps walk the steps; the other
// warps join only the full scorings.  A step costs:
//
//   1. warp m, the maintainer of the step's slot, sends the CTA's best
//      (score and index, 8 bytes) into every other CTA's exchange slot
//      with st.async, counted on that CTA's transaction mbarrier; slots
//      and mbarriers are double-buffered by step parity;
//   2. while the candidates travel, every maintainer computes what its
//      slot would become if this CTA's best wins and is placed: the
//      node's new score (usage + ask, job count + 1), its warp's best,
//      the CTA's best;
//   3. once its mbarrier holds the other csize - 1 candidates, each
//      maintainer reduces them with its own CTA's (from its slot state)
//      in the same order, ties to the lower index, so all
//      agree on the winner; where this CTA owns it and it is placed,
//      they commit what they computed and warp 0 updates the node's
//      usage and job count (a step that places nothing adds +0.0,
//      changing no score).  The maintainers meet at a named barrier
//      before the commits (all have read the step's state) and after
//      them (the next step reads them).
//
// Reuse of a parity's exchange slot is safe without a cluster barrier:
// a CTA sends step p+2 only after it holds every CTA's step p+1, and a
// CTA sends step p+1 only after all its maintainers read step p.  So a
// step's chain is one one-way message, one warp reduction and a few
// shared memory writes; the rescoring of a placed node overlaps the
// message.
__device__ __forceinline__ void place_sequence_cluster_lane(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ group_idx,
    const uint8_t* __restrict__ valid, float penalty, int n, int g_len,
    int p_len, int* __restrict__ chosen, float* __restrict__ scores,
    float* usage, int* jc, int rank, int csize, int slots, int mode,
    void* cache) {
  __shared__ uint2 s_x[2][MAX_CLUSTER];  // (score bits, index) per CTA
  __shared__ uint64_t s_mbar[2];
  __shared__ float s_wv[MAX_SLOTS][WARPS];
  __shared__ int s_wi[MAX_SLOTS][WARPS];
  __shared__ int s_slot_group[MAX_SLOTS];
  __shared__ float s_slot_bv[MAX_SLOTS];
  __shared__ int s_slot_bi[MAX_SLOTS];
  __shared__ float s_asks[MAX_SLOTS * NDIMS];
  __shared__ uint8_t s_dist[MAX_SLOTS];
  __shared__ int s_step[STEP_CHUNK];  // group, or ~group where invalid
  __shared__ int s_chosen[STEP_CHUNK];
  __shared__ float s_scores[STEP_CHUNK];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int npc = n / csize;
  const int base = rank * npc;

  // Carve the node state and the caches (4-byte aligned pieces).
  const float* cap_l = cap + (size_t)base * NDIMS;
  const float* res_l = res + (size_t)base * NDIMS;
  float* use_l = usage + (size_t)base * NDIMS;
  int* jc_l = jc + base;
  uint8_t* fe_cache = nullptr;
  float* sc;
  if (mode == SEQ_SHARED) {
    float* s_cap = reinterpret_cast<float*>(cache);
    float* s_res = s_cap + (size_t)npc * NDIMS;
    float* s_use = s_res + (size_t)npc * NDIMS;
    int* s_jc = reinterpret_cast<int*>(s_use + (size_t)npc * NDIMS);
    for (int i = tid; i < npc * NDIMS; i += THREADS) {
      s_cap[i] = cap_l[i];
      s_res[i] = res_l[i];
      s_use[i] = usage0[(size_t)base * NDIMS + i];
    }
    for (int i = tid; i < npc; i += THREADS) s_jc[i] = jc0[base + i];
    cap_l = s_cap;
    res_l = s_res;
    use_l = s_use;
    jc_l = s_jc;
    sc = reinterpret_cast<float*>(s_jc + npc);
    fe_cache = reinterpret_cast<uint8_t*>(sc + (size_t)slots * npc);
  } else {
    sc = reinterpret_cast<float*>(cache) + (size_t)base * slots;
    copy_state(usage0 + (size_t)base * NDIMS, jc0 + base, use_l, jc_l, npc);
  }
  if (tid < slots) s_slot_group[tid] = -1;
  const bool staged = g_len <= MAX_SLOTS;
  if (staged) {
    for (int i = tid; i < g_len * NDIMS; i += THREADS) s_asks[i] = asks[i];
    for (int i = tid; i < g_len; i += THREADS) s_dist[i] = distinct[i];
  }
  const float* ask_src = staged ? s_asks : asks;
  const uint8_t* dist_src = staged ? s_dist : distinct;
  if (tid == 0) {
    mbar_init(&s_mbar[0]);
    mbar_init(&s_mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Every CTA has started and initialised its mbarriers.
  cluster_arrive_release();
  cluster_wait_acquire();

  // This warp's slot as a maintainer (-1: none), and where its lane r
  // sends this CTA's candidate: CTA r's exchange slot and mbarrier.
  const int own = warp < slots ? warp : -1;
  float* own_sc = sc + (size_t)(own < 0 ? 0 : own) * npc;
  uint32_t x_to[2] = {0, 0}, bar_to[2] = {0, 0};
  if (lane < csize) {
    for (int q = 0; q < 2; ++q) {
      x_to[q] = cluster_addr(&s_x[q][rank], lane);
      bar_to[q] = cluster_addr(&s_mbar[q], lane);
    }
  }
  float best = NEG_INF;
  int bi = 0;
  for (int p = 0; p < p_len; ++p) {
    const int k = p & (STEP_CHUNK - 1);
    if (k == 0) {  // stage the next chunk, flush the last one's results
      __syncthreads();
      if (rank == 0 && p > 0)
        flush_steps(chosen, scores, s_chosen, s_scores, p - STEP_CHUNK,
                    STEP_CHUNK);
      for (int i = tid; i < STEP_CHUNK && p + i < p_len; i += THREADS)
        s_step[i] = valid[p + i] ? group_idx[p + i] : ~group_idx[p + i];
      __syncthreads();
    }
    const int code = s_step[k];
    const int g = code >= 0 ? code : ~code;
    const int slot = slots > 1 ? g : 0;
    const int lead = slot;  // the slot's maintainer warp
    const float* ask = ask_src + (size_t)g * NDIMS;
    if (s_slot_group[slot] != g) {  // uniform: score the slot in full
      __syncthreads();  // the maintainers' last commits
      const uint8_t* fe = feas + (size_t)g * n + base;
      float* sc_s = sc + (size_t)slot * npc;
      if (fe_cache != nullptr) {
        uint8_t* fc = fe_cache + (size_t)slot * npc;
        for (int li = tid; li < npc; li += THREADS) fc[li] = fe[li];
        fe = fc;  // each thread reads only the bytes it wrote
      }
      const bool dist = dist_src[g] != 0;
      best = __int_as_float(0xff800000);  // -inf
      bi = 0x7fffffff;
      for (int li = tid; li < npc; li += THREADS) {
        const float s = score_node(cap_l, res_l, use_l, jc_l, ask, fe, dist,
                                   penalty, li);
        sc_s[li] = s;
        if (s > best) {  // strided walk: the first max per thread is lowest
          best = s;
          bi = base + li;
        }
      }
      block_argmax(best, bi, s_wv[slot], s_wi[slot], lead);
      if (warp == lead && lane == 0) {
        s_slot_group[slot] = g;
        s_slot_bv[slot] = best;
        s_slot_bi[slot] = bi;
      }
      __syncthreads();
    } else if (warp == lead) {
      best = s_slot_bv[slot];
      bi = s_slot_bi[slot];
    }
    if (own < 0) continue;  // the other warps only join full scorings

    // 1. Send this CTA's candidate to the others; expect theirs.
    const int par = p & 1;
    if (csize > 1) {
      if (tid == 0) mbar_expect(&s_mbar[par], (csize - 1) * 8);
      if (warp == lead && lane < csize && lane != rank)
        send_pair(x_to[par], bar_to[par], __float_as_uint(best),
                  (uint32_t)bi);
    }

    // 2. What the own slot becomes if this CTA's best wins and places.
    const float cand_v = s_slot_bv[slot];
    const int cand_i = s_slot_bi[slot];
    const int lic = cand_i - base;
    const bool spec =
        code >= 0 && cand_v > NEG_INF / 2 && s_slot_group[own] >= 0;
    float sp_score = 0.0f, sp_wv = 0.0f, sp_bv = 0.0f;
    int sp_wi = 0, sp_bi = 0;
    const int wc = (lic & (THREADS - 1)) >> 5;  // the candidate's warp
    if (spec) {
      if (lane == 0) {
        const int gs = s_slot_group[own];
        const uint8_t fe = fe_cache != nullptr
                               ? fe_cache[(size_t)own * npc + lic]
                               : feas[(size_t)gs * n + base + lic];
        float u2[NDIMS];
#pragma unroll
        for (int d = 0; d < NDIMS; ++d)
          u2[d] = __fadd_rn(use_l[(size_t)lic * NDIMS + d], ask[d]);
        sp_score = score_values(
            cap_l + (size_t)lic * NDIMS, res_l + (size_t)lic * NDIMS, u2,
            jc_l[lic] + 1, ask_src + (size_t)gs * NDIMS, fe != 0,
            dist_src[gs] != 0, penalty);
      }
      sp_score = __shfl_sync(0xffffffffu, sp_score, 0);
      sp_wv = __int_as_float(0xff800000);
      sp_wi = 0x7fffffff;
      for (int li = wc * 32 + lane; li < npc; li += THREADS) {
        const float v = li == lic ? sp_score : own_sc[li];
        if (v > sp_wv) {
          sp_wv = v;
          sp_wi = base + li;
        }
      }
      warp_argmax(sp_wv, sp_wi);
      sp_bv = lane == wc ? sp_wv : s_wv[own][lane];
      sp_bi = lane == wc ? sp_wi : s_wi[own][lane];
      warp_argmax(sp_bv, sp_bi);
    }

    // 3. The winner, then its owner's commit.
    float wvv = cand_v;
    int wii = cand_i;
    if (csize > 1) {
      mbar_wait(&s_mbar[par], (p >> 1) & 1);
      if (lane != rank) {
        wvv = __int_as_float(0xff800000);
        wii = 0x7fffffff;
        if (lane < csize) {
          const uint2 x = s_x[par][lane];
          wvv = __uint_as_float(x.x);
          wii = (int)x.y;
        }
      }
      warp_argmax(wvv, wii);
    }
    const bool ok = code >= 0 && wvv > NEG_INF / 2;
    if (rank == 0 && tid == 0) {
      s_chosen[k] = ok ? wii : -1;
      s_scores[k] = wvv;
    }
    const int li = wii - base;
    warps_sync(slots);  // every maintainer has read the step's state
    if (li >= 0 && li < npc && lane == 0) {  // this CTA owns the winner
      if (ok && spec) {  // li == lic: the winner is this CTA's best
        own_sc[li] = sp_score;
        s_wv[own][wc] = sp_wv;
        s_wi[own][wc] = sp_wi;
        s_slot_bv[own] = sp_bv;
        s_slot_bi[own] = sp_bi;
      }
      if (warp == 0) {
        add_step(use_l + (size_t)li * NDIMS, ask, ok);
        if (ok) jc_l[li] += 1;
      }
    }
    warps_sync(slots);  // the next step reads the commits
  }
  __syncthreads();
  if (rank == 0 && p_len > 0) {
    const int c0 = (p_len - 1) & ~(STEP_CHUNK - 1);
    flush_steps(chosen, scores, s_chosen, s_scores, c0, p_len - c0);
  }
  if (mode == SEQ_SHARED) {
    for (int i = tid; i < npc * NDIMS; i += THREADS)
      usage[(size_t)base * NDIMS + i] = use_l[i];
    for (int i = tid; i < npc; i += THREADS) jc[base + i] = jc_l[i];
  }
  // No CTA leaves while another may still write its shared memory.
  cluster_arrive_release();
  cluster_wait_acquire();
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Steps of stride `j` down to 1 of the merge of runs of k keys on key
// a of this lane, in registers: its partner a ^ st is lane lane ^ st of
// the same warp (st < 32), and the lower position keeps the larger key
// where the run is descending.
__device__ __forceinline__ unsigned long long warp_merge(
    unsigned long long x, int a, int k, int j) {
  const int lane = threadIdx.x & 31;
  const bool desc = (a & k) == 0;
  for (int st = j; st > 0; st >>= 1) {
    const unsigned long long y = __shfl_xor_sync(FULL_MASK, x, st);
    const bool keep_max = ((lane & st) == 0) == desc;
    x = keep_max ? (x > y ? x : y) : (x < y ? x : y);
  }
  return x;
}

// Block-wide bitonic sort of n (a power of two) keys, descending.  Runs
// of up to 32 keys are sorted in registers by shuffles, one barrier in
// all; a merge step of stride j >= 32 exchanges keys in place, one
// barrier a step, and the merge's steps of stride 16 down to 1 run in
// registers again, one barrier for all of them (at n = 1,024: 21
// barriers for the 55 steps).
__device__ void bitonic_sort_desc(unsigned long long* keys, int n) {
  const int half = n >> 1;
  const int lane = threadIdx.x & 31;
  // Loop bounds below are uniform across a warp (a - lane is its first
  // key): every lane takes part in the shuffles.
  for (int a = threadIdx.x; a - lane < n; a += THREADS) {
    unsigned long long x = a < n ? keys[a] : 0ull;
    for (int k = 2; k <= n && k <= 32; k <<= 1)
      x = warp_merge(x, a, k, k >> 1);
    if (a < n) keys[a] = x;
  }
  __syncthreads();
  for (int k = 64; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
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
    for (int a = threadIdx.x; a < n; a += THREADS)
      keys[a] = warp_merge(keys[a], a, k, 16);
    __syncthreads();
  }
}

// The smallest power of two >= x (x >= 1).
__host__ __device__ __forceinline__ int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// K3/K4a's sort key of node i: its ordered score bits, then its inverted
// index, so a descending sort puts ties in index order.
__device__ __forceinline__ unsigned long long sort_key(uint32_t ordered,
                                                       int i) {
  return ((unsigned long long)ordered << 32) |
         (unsigned long long)(~(uint32_t)i);
}

// Adds one to bin `digit` of `hist` for each lane where `active`: one
// shared-memory atomic per distinct digit in the warp, so keys that all
// fall into one bin (a uniform fleet) cost one atomic a warp, not 32.
// A warp whose active digits are all one (the common case there) takes
// a vote instead of __match_any_sync.
__device__ __forceinline__ void hist_add(int* hist, bool active,
                                         uint32_t digit) {
  const unsigned act = __ballot_sync(FULL_MASK, active);
  if (act == 0u) return;
  const int lane = threadIdx.x & 31;
  const int lead = __ffs(act) - 1;
  const uint32_t d0 = __shfl_sync(FULL_MASK, digit, lead);
  if (__all_sync(FULL_MASK, !active || digit == d0)) {
    if (lane == lead) atomicAdd(&hist[d0], __popc(act));
    return;
  }
  if (active) {
    const unsigned peers = __match_any_sync(act, digit);
    if (lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
  }
}

// hist_add for the 4 keys of each lane: one vote and one atomic where
// every active key of the warp has the same digit, else hist_add on
// each key.
__device__ __forceinline__ void hist_add4(int* hist, const bool* active,
                                          const uint32_t* digit) {
  int cnt = 0;
  uint32_t d = 0u;
  bool same = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (active[e]) {
      if (cnt == 0) d = digit[e];
      same = same && digit[e] == d;
      ++cnt;
    }
  }
  const unsigned has = __ballot_sync(FULL_MASK, cnt > 0);
  if (has == 0u) return;
  const int lead = __ffs(has) - 1;
  const uint32_t d0 = __shfl_sync(FULL_MASK, d, lead);
  if (__all_sync(FULL_MASK, cnt == 0 || (same && d == d0))) {
    const int total = __reduce_add_sync(FULL_MASK, cnt);
    if ((int)(threadIdx.x & 31) == lead) atomicAdd(&hist[d0], total);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) hist_add(hist, active[e], digit[e]);
}

// Whether any of the n feasibility bytes at f is set, block-wide (holds
// one barrier): 16 bytes a load where f is aligned and n a multiple of
// 16, so a padded slot costs one load a thread at N = 16,384.
__device__ __forceinline__ bool any_set(const uint8_t* __restrict__ f,
                                        int n) {
  bool any = false;
  if ((reinterpret_cast<uintptr_t>(f) & 15) == 0 && (n & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(f);
    for (int i = threadIdx.x; i < (n >> 4) && !any; i += THREADS) {
      const uint4 q = v[i];
      any = (q.x | q.y | q.z | q.w) != 0u;
    }
  } else {
    for (int i = threadIdx.x; i < n && !any; i += THREADS) any = f[i] != 0;
  }
  return __syncthreads_or(any);
}

// The radix select's state: the keys whose bits under `mask` equal
// `prefix` are the candidates; every key above them is in the top k_cap,
// and so are the `need` candidates of lowest index; `done` once the
// candidates need no further digit (all of them are needed, or the key
// is fully known).
struct TopkSel {
  uint32_t prefix, mask;
  int need, done;
};

// Warp 0, before the first digit: where the largest key occurs at least
// `need` times (every feasible node of a uniform fleet scores the same),
// it is the threshold and no digit pass is needed.  s_max / s_count
// hold each warp's largest key and how often it occurs there.
__device__ __forceinline__ bool take_max(TopkSel* sel, const int* s_max,
                                         const int* s_count) {
  const int lane = threadIdx.x & 31;
  const uint32_t wmax = (uint32_t)s_max[lane];
  const uint32_t kmax = __reduce_max_sync(FULL_MASK, wmax);
  const int count = __reduce_add_sync(FULL_MASK,
                                      wmax == kmax ? s_count[lane] : 0);
  const int need = sel->need;
  __syncwarp();  // every lane has read sel before lane 0 writes it
  if (count < need) return false;  // uniform across the warp
  if (lane == 0) *sel = TopkSel{kmax, FULL_MASK, need, 1};
  return true;
}

// Warp 0: from the candidates' histogram over the digit at `shift`, the
// digit of the need-th largest candidate; narrows `sel` to it.  Lane l
// holds bins 255 - 8l down to 248 - 8l, so a scan over the lanes counts
// the candidates above each lane's bins.
__device__ __forceinline__ void pick_digit(const int* hist, TopkSel* sel,
                                           int shift) {
  const int lane = threadIdx.x & 31;
  int c[8];
  int sum = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    c[t] = hist[RADIX_BINS - 1 - 8 * lane - t];
    sum += c[t];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += v;
  }
  const int need = sel->need;
  int above = incl - sum;
  __syncwarp();  // every lane has read sel before one lane writes it
  if (above < need && need <= incl) {  // exactly one lane
    int digit = -1, count = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (digit < 0) {
        if (above + c[t] >= need) {
          digit = RADIX_BINS - 1 - 8 * lane - t;
          count = c[t];
        } else {
          above += c[t];
        }
      }
    }
    sel->prefix |= (uint32_t)digit << shift;
    sel->mask |= 0xffu << shift;
    sel->need = need - above;
    sel->done = need - above == count || shift == 0;
  }
}

// One round's top k_cap by selection, for the state it is called with:
// leaves the k_cap best 64-bit keys (sort_key), sorted descending, in the
// first pow2_ceil(k_cap) 8-byte entries of `keys` (padding entries 0 sort
// last).  `keys` holds max(4 n, 8 pow2_ceil(k_cap)) bytes, 16-byte
// aligned, and n is a multiple of 4 (the passes and the gather read 4
// keys a thread in one load):
//
//   1. every node's ordered score into word i of `keys`, with the
//      histogram of the top digit;
//   2. none where the largest key occurs k_cap times or more (take_max);
//      else digit passes of 8 bits, each a warp-aggregated histogram of
//      the candidates' next digit and a scan that picks the digit, until
//      the candidates left are exactly the keys still needed or the key
//      is known to its last bit (4 passes at most);
//   3. an ordered compaction in node order (4 nodes a thread, a warp
//      scan, one exchange of per-warp counts a chunk of 4,096 nodes):
//      word j gets the index of the j-th taken node, every key above the
//      candidates and the `need` candidates of lowest index, which is
//      lax.top_k's choice among ties.  Word j <= node i: a chunk reads
//      its keys before its barrier and writes only words at or below
//      them;
//   4. the taken nodes' 64-bit keys, their scores computed again (the
//      state has not changed), top chunk first: chunk [lo, hi) reads
//      words [lo, hi) and writes words [2 lo, 2 hi), which no later chunk
//      reads; then a bitonic sort of those keys alone.
__device__ void select_topk(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* usage, const int* jc, const float* ask,
    const uint8_t* __restrict__ feas, bool dist, float penalty, int n,
    int k_cap, void* keys, int* hist, TopkSel* s_sel, int (*s_cnt)[WARPS]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t* words = reinterpret_cast<uint32_t*>(keys);
  unsigned long long* keys64 = reinterpret_cast<unsigned long long*>(keys);

  // 1. Score, with the largest key and its count (per thread, then per
  // warp into s_cnt).
  if (tid < RADIX_BINS) hist[tid] = 0;
  if (tid == 0) *s_sel = TopkSel{0u, 0u, k_cap, 0};
  __syncthreads();
  uint32_t kmax = 0u;
  int count = 0;
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + tid;
    uint32_t key = 0u;
    if (i < n) {
      key = ordered_bits(
          score_node(cap, res, usage, jc, ask, feas, dist, penalty, i));
      words[i] = key;
      count = key > kmax ? 1 : count + (key == kmax);
      kmax = key > kmax ? key : kmax;
    }
    hist_add(hist, i < n, key >> 24);
  }
  const uint32_t wmax = __reduce_max_sync(FULL_MASK, kmax);
  count = __reduce_add_sync(FULL_MASK, kmax == wmax ? count : 0);
  if (lane == 0) {
    s_cnt[0][warp] = (int)wmax;
    s_cnt[1][warp] = count;
  }
  __syncthreads();

  // 2. The threshold, a digit a pass.
  TopkSel sel;
  for (int shift = 24;; shift -= 8) {
    if (warp == 0 && !(shift == 24 && take_max(s_sel, s_cnt[0], s_cnt[1])))
      pick_digit(hist, s_sel, shift);
    __syncthreads();
    sel = *s_sel;
    if (sel.done) break;  // uniform
    if (tid < RADIX_BINS) hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += 4 * THREADS) {
      const int i0 = base + 4 * tid;  // this thread's 4 keys, one load
      const uint4 q = i0 < n ? reinterpret_cast<const uint4*>(words)[i0 >> 2]
                             : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t key[4] = {q.x, q.y, q.z, q.w};
      bool active[4];
      uint32_t digit[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        active[e] = i0 < n && (key[e] & sel.mask) == sel.prefix;
        digit[e] = (key[e] >> (shift - 8)) & 0xffu;
      }
      hist_add4(hist, active, digit);
    }
    __syncthreads();
  }

  // 3. Ordered compaction of the taken indices, 4 consecutive nodes a
  // thread: (candidates, keys above) counted a thread, scanned over the
  // warp, each warp's total exchanged once a chunk (double-buffered).
  int taken = 0, seen = 0;  // uniform: nodes taken, candidates seen
  for (int base = 0, c = 0; base < n; base += 4 * THREADS, c ^= 1) {
    const int i0 = base + 4 * tid;
    const uint4 q = i0 < n ? reinterpret_cast<const uint4*>(words)[i0 >> 2]
                           : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t key[4] = {q.x, q.y, q.z, q.w};
    int eq = 0, gt = 0;  // bit e: key e is a candidate / above them
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t top = key[e] & sel.mask;
      if (i0 < n && top == sel.prefix) eq |= 1 << e;
      if (i0 < n && top > sel.prefix) gt |= 1 << e;
    }
    const int mine = __popc(eq) | (__popc(gt) << 16);
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_cnt[c][warp] = incl;
    __syncthreads();
    const int v = s_cnt[c][lane];
    const int before =
        __reduce_add_sync(FULL_MASK, lane < warp ? v : 0) + incl - mine;
    const int total = __reduce_add_sync(FULL_MASK, v);
    const int rem = max(0, sel.need - seen);
    int eq_before = before & 0xffff, gt_before = before >> 16;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool is_eq = (eq >> e) & 1, is_gt = (gt >> e) & 1;
      if (is_gt || (is_eq && eq_before < rem))
        words[taken + gt_before + min(eq_before, rem)] = (uint32_t)(i0 + e);
      eq_before += is_eq;
      gt_before += is_gt;
    }
    taken += (total >> 16) + min(total & 0xffff, rem);
    seen += total & 0xffff;
  }
  __syncthreads();

  // 4. Their 64-bit keys, then the sort.
  const int m = pow2_ceil(k_cap);
  for (int hi = m; hi > 0; hi -= THREADS) {
    const int lo = hi > THREADS ? hi - THREADS : 0;
    const int j = lo + tid;
    unsigned long long key = 0ull;
    if (j < k_cap) {
      const int idx = (int)words[j];
      key = sort_key(ordered_bits(score_node(cap, res, usage, jc, ask, feas,
                                             dist, penalty, idx)),
                     idx);
    }
    __syncthreads();
    if (j < hi) keys64[j] = key;
  }
  __syncthreads();
  bitonic_sort_desc(keys64, m);
}

// K3: for each slot, `rounds` rounds of score -> top-k_cap -> place at
// up to min(remaining, k_cap) distinct winners; every winner not taken
// gets +0.0, as in the reference.  The top-k (path TOPK_SELECT:
// select_topk; TOPK_SORT: a full sort of N 64-bit keys) returns the k
// largest with ties to the lower index, as lax.top_k, as 64-bit keys
// sorted descending at the start of `keys`.  A round after one that
// placed nothing reuses them (the state changed only by +0.0 adds), so a
// slot's exhausted rounds cost one top-k, and a slot with no feasible
// node neither a scoring nor a top-k.  What bounds a round is its chain
// of block-wide steps on one SM: at N = 16,384 and k_cap = 1,024 the
// scoring (two powf a node), up to 3 digit passes (none on a uniform
// fleet), 4 gather chunks and a sort of 1,024 keys with 21 barriers,
// where the full sort took 105 barriers over N keys.
__device__ __forceinline__ void place_rounds_lane(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ counts,
    float penalty, int n, int g_len, int k_cap, int rounds, int path,
    int* __restrict__ chosen, float* __restrict__ scores, float* usage,
    int* jc, void* keys) {
  __shared__ float s_ask[NDIMS];
  __shared__ int s_hist[RADIX_BINS];
  __shared__ int s_cnt[2][WARPS];
  __shared__ TopkSel s_sel;
  unsigned long long* keys64 = reinterpret_cast<unsigned long long*>(keys);
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
    bool sorted = false;  // keys hold this slot's order for the state
    for (int r = 0; r < rounds; ++r) {
      int* out_c = chosen + (size_t)s * stream_len + (size_t)r * k_cap;
      float* out_s = scores + (size_t)s * stream_len + (size_t)r * k_cap;
      if (!sorted) {  // uniform across the block
        // A slot with no feasible node (a padded slot) scores -1e30
        // everywhere: every key holds the same score word, so its first
        // k_cap keys in index order are its top-k (lower index first).
        if (!any_set(feas_s, n)) {
          for (int i = tid; i < k_cap; i += THREADS)
            keys64[i] = sort_key(ordered_bits(NEG_INF), i);
          __syncthreads();
        } else if (path == TOPK_SELECT) {
          select_topk(cap, res, usage, jc, s_ask, feas_s, dist, penalty, n,
                      k_cap, keys, s_hist, &s_sel, s_cnt);
        } else {
          for (int i = tid; i < n; i += THREADS)
            keys64[i] = sort_key(ordered_bits(score_node(
                                     cap, res, usage, jc, s_ask, feas_s,
                                     dist, penalty, i)),
                                 i);
          __syncthreads();
          bitonic_sort_desc(keys64, n);
        }
        sorted = true;
      }
      int placed = 0;
      for (int base = 0; base < k_cap; base += THREADS) {
        const int pos = base + tid;
        bool take = false;
        if (pos < k_cap) {
          const unsigned long long key = keys64[pos];
          const int idx = (int)(~(uint32_t)(key & 0xffffffffull));
          const float val = from_ordered((uint32_t)(key >> 32));
          take = pos < m && val > NEG_INF / 2;
          out_c[pos] = take ? idx : -1;
          out_s[pos] = val;
          // Winners are distinct: no two threads share a row.
          float* u = usage + (size_t)idx * NDIMS;
#pragma unroll
          for (int d = 0; d < NDIMS; ++d)
            u[d] = __fadd_rn(u[d], take ? s_ask[d] : 0.0f);
          if (take) jc[idx] += 1;
        }
        placed += __syncthreads_count(take);
      }
      m -= placed;
      if (placed > 0) sorted = false;
    }
    __syncthreads();
  }
}


// The kernels.  A K3/K4a lane's key region (topk_key_bytes) lives in
// the block's dynamic shared memory up to KEYS_SMEM_MAX bytes (N =
// 32,768 on the select path, 16,384 on the full sort); above that, in
// the caller's scratch (one row of key words per lane).
//
// K2: ONE cluster of gridDim.x CTAs (a power of two up to 16), with the
// slots and mode nomad_place_sequence_plan chose; `scratch` (slots * n
// floats: each CTA's [slots][npc] scores) in mode SEQ_SCRATCH.
//
// Bound on an H100: at N = 16,384 and P = 1,024 the function needs one
// scoring of N nodes per group change and one node per placement, ~1.5
// MB of distinct input: a few microseconds.  What bounds it is the
// chain of P dependent steps; the design makes each step short, not
// parallel: 16 SMs score 1,024 nodes each (one a thread) the first time
// a group is asked for, and from then on the rescoring of a placed node
// and the new warp and CTA bests are computed while the step's
// candidates travel, so a step's chain is one message through
// distributed shared memory and one warp reduction.
__global__ void __launch_bounds__(THREADS, 1) place_sequence_kernel(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ group_idx,
    const uint8_t* __restrict__ valid, float penalty, int n, int g_len,
    int p_len, int slots, int mode, int* __restrict__ chosen,
    float* __restrict__ scores, float* usage, int* jc, float* scratch) {
  extern __shared__ float4 s_cache[];
  place_sequence_cluster_lane(
      cap, res, usage0, jc0, feas, asks, distinct, group_idx, valid, penalty,
      n, g_len, p_len, chosen, scores, usage, jc,
      (int)cg::this_cluster().block_rank(),
      (int)cg::this_cluster().num_blocks(), slots, mode,
      mode == SEQ_SCRATCH ? (void*)scratch : (void*)s_cache);
}

__global__ void __launch_bounds__(THREADS) place_rounds_kernel(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ counts,
    float penalty, int n, int g_len, int k_cap, int rounds, int path,
    int* __restrict__ chosen, float* __restrict__ scores, float* usage,
    int* jc, uint32_t* scratch) {
  extern __shared__ unsigned long long s_keys[];
  place_rounds_lane(cap, res, usage0, jc0, feas, asks, distinct, counts,
                    penalty, n, g_len, k_cap, rounds, path, chosen, scores,
                    usage, jc,
                    scratch != nullptr ? (void*)scratch : (void*)s_keys);
}

// K4b (nomad_tpu/ops/binpack.py place_sequence_batch): K2 over B lanes,
// one thread-block cluster per lane running K2's body, with the cluster
// size, score slots and mode of nomad_place_sequence_batch_plan.  The
// grid is lanes x csize CTAs; clusters tile it in order, so the lane is
// the cluster's index.  Each cluster reads its lane's slices of the
// per-lane operands and the SHARED capacity / reserved / usage0, writes
// its lane's slices of usage and job counts, and in SEQ_SCRATCH mode
// keeps its score slots in its lane's slots * n floats of `scratch`.
//
// Bound on an H100: at B = 8 lanes, N = 16,384, P = 256 the function
// needs one scoring of the fleet per group a lane names and one node per
// placement, ~2 MB of distinct input: ~1 us.  What bounds it is each
// lane's chain of P dependent steps; every lane takes K2's short steps
// (a placement rescores one node, the candidates of a step travel by
// st.async inside the cluster), and the lanes run side by side as long
// as their clusters fit one wave of the card (the plan's rule).
__global__ void __launch_bounds__(THREADS, 1) place_sequence_batch_kernel(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ group_idx,
    const uint8_t* __restrict__ valid, const float* __restrict__ penalty,
    int n, int g_len, int p_len, int slots, int mode,
    int* __restrict__ chosen, float* __restrict__ scores, float* usage,
    int* jc, float* scratch) {
  extern __shared__ float4 s_cache[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const size_t b = blockIdx.x / csize;
  const size_t nn = (size_t)n;
  place_sequence_cluster_lane(
      cap, res, usage0, jc0 + b * nn, feas + b * (size_t)g_len * nn,
      asks + b * (size_t)g_len * NDIMS, distinct + b * (size_t)g_len,
      group_idx + b * (size_t)p_len, valid + b * (size_t)p_len, penalty[b],
      n, g_len, p_len, chosen + b * (size_t)p_len,
      scores + b * (size_t)p_len, usage + b * nn * NDIMS, jc + b * nn,
      (int)cluster.block_rank(), csize, slots, mode,
      mode == SEQ_SCRATCH ? (void*)(scratch + b * (size_t)slots * nn)
                          : (void*)s_cache);
}

// K4a (nomad_tpu/ops/binpack.py place_rounds_batch): K3 over B lanes,
// one block per lane.
//
// Bound on an H100: config 5 (B = 64 lanes, N = 16,384, one slot of
// 1,000 copies, one round) reads ~1.5 MB of shared fleet tensors and
// 1 MB of per-lane feasibility and writes 25 MB of per-lane usage:
// ~8 us at 3.35 TB/s, bytes-bound.  Each lane's chain of block-wide
// steps on one SM holds it: the scoring of 16,384 nodes, ~4 digit passes
// over their 32-bit keys, the gather and a sort of k_cap = 1,024 keys
// (select_topk).  The 64 lanes run side by side, one block with 64 KB
// of keys per SM, so the storm costs about one K3 launch, not 64.
__global__ void __launch_bounds__(THREADS) place_rounds_batch_kernel(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ counts,
    const float* __restrict__ penalty, int n, int g_len, int k_cap,
    int rounds, int path, int key_words, int* __restrict__ chosen,
    float* __restrict__ scores, float* usage, int* jc, uint32_t* scratch) {
  extern __shared__ unsigned long long s_keys[];
  const size_t b = blockIdx.x;
  const size_t nn = (size_t)n;
  const size_t stream = (size_t)g_len * rounds * k_cap;
  place_rounds_lane(
      cap, res, usage0, jc0 + b * nn, feas + b * (size_t)g_len * nn,
      asks + b * (size_t)g_len * NDIMS, distinct + b * (size_t)g_len,
      counts + b * (size_t)g_len, penalty[b], n, g_len, k_cap, rounds, path,
      chosen + b * stream, scores + b * stream, usage + b * nn * NDIMS,
      jc + b * nn,
      scratch != nullptr ? (void*)(scratch + b * (size_t)key_words)
                         : (void*)s_keys);
}

// K3/K4a's top-k path for n nodes and k_cap, the rule: the full sort
// where k_cap >= n / 2 (the select would still sort k_cap keys after its
// passes: 1.47 against 1.77 ms at n = k_cap = 16,384), else the select.
// At the main path's small launches (n = 1,024 and 256, k_cap <= n / 4)
// the two paths time within 4% of each other, at n = 16,384 the select
// is 2.3-4.2x faster (chip_smoke.py, H100).  The wrappers may force
// either path: both compute the same function, and chip_smoke.py holds
// and times both.
static int topk_path(int n, int k_cap) {
  return 2 * k_cap >= n ? TOPK_SORT : TOPK_SELECT;
}

// Bytes of one lane's key region: n 64-bit keys for the full sort; for
// the select, n 32-bit keys, later overwritten by the pow2_ceil(k_cap)
// 64-bit keys it sorts.
static size_t topk_key_bytes(int n, int k_cap, int path) {
  if (path == TOPK_SORT) return (size_t)n * 8;
  const size_t words = (size_t)n * 4;
  const size_t top = (size_t)pow2_ceil(k_cap) * 8;
  return words > top ? words : top;
}

// Dynamic shared memory of one K3/K4a block: the lane's key region of
// `bytes` when it fits (and the attribute raised past 48 KB), 0 when
// the caller passed a scratch buffer.  Returns a CUDA error code.
template <typename Kernel>
static int keys_smem(Kernel kernel, size_t bytes, const void* scratch,
                     size_t* smem) {
  *smem = 0;
  if (scratch != nullptr) return 0;
  if (bytes > KEYS_SMEM_MAX) return (int)cudaErrorInvalidValue;
  *smem = bytes;
  if (*smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  }
  return 0;
}

// Dynamic shared memory of one K2 CTA with npc nodes: in SEQ_SHARED the
// node state (capacity, reserved, usage: 18 floats, a job count) and per
// slot the scores and the feasibility bytes; none in SEQ_SCRATCH.
static size_t sequence_smem(size_t npc, int slots, int mode) {
  if (mode == SEQ_SCRATCH) return 0;
  return npc * (3 * NDIMS + 1) * 4 + (size_t)slots * npc * 5;
}

// The launch configuration of K2 (lanes = 1) and K4b: one cluster of
// `csize` CTAs per lane.
static cudaLaunchConfig_t sequence_config(int n, int csize, int slots,
                                          int mode, int lanes, void* stream,
                                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * lanes, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = sequence_smem((size_t)(n / csize), slots, mode);
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The mode of a K2/K4b CTA with npc nodes: SEQ_SHARED where its shared
// memory fits, else SEQ_SCRATCH.
static int sequence_mode(size_t npc, int slots) {
  return sequence_smem(npc, slots, SEQ_SHARED) <= CACHE_SMEM_MAX
             ? SEQ_SHARED
             : SEQ_SCRATCH;
}

// Clusters of `csize` CTAs the card runs at once for `kernel` (0 when it
// refuses the size).
template <typename Kernel>
static int sequence_clusters(Kernel kernel, int n, int csize, int slots) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = sequence_config(
      n, csize, slots, sequence_mode((size_t)(n / csize), slots), 1,
      nullptr, &attr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
      cudaSuccess) {
    (void)cudaGetLastError();  // a refused size is not an error yet
    return 0;
  }
  return clusters;
}

// Raises the attributes a K2/K4b launch needs on `kernel`.
template <typename Kernel>
static cudaError_t sequence_attributes(Kernel kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CACHE_SMEM_MAX);
  return e;
}

// K2's rule for the cluster of one lane: n / 1,024 CTAs clamped to
// [1, 16], then halved until cudaOccupancyMaxActiveClusters finds room
// for one cluster.  0 when no size can run.
template <typename Kernel>
static int sequence_csize(Kernel kernel, int n, int slots) {
  int csize = n / THREADS;
  csize = csize < 1 ? 1 : (csize > MAX_CLUSTER ? MAX_CLUSTER : csize);
  for (; csize >= 1; csize >>= 1)
    if (sequence_clusters(kernel, n, csize, slots) >= 1) return csize;
  return 0;
}

// ---------------------------------------------------------------------------
// K7: the node-axis-sharded walks (nomad_tpu/parallel/mesh.py :210, :252,
// :279, :314; driven by nomad_tpu_torch/parallel/mesh.py).
//
// The node axis is split into S shards of R = N / S rows, each shard its
// own tensors on its own device (several shards may name one card).  XLA
// turns the JAX walks' argmax and top_k over a sharded axis into
// per-shard work, a cross-shard merge and a row update on the owner;
// here each step of a walk (one placement of K2/K4b, one round of a slot
// of K3/K4a) is two launches on one card, driven by the host without
// waiting:
//
//   K7a+c shard_step_kernel, once per card and mesh row, one block per
//       (lane, shard) of the row's shards on that card: first the
//       shard's slice of the previous step's updates (K7c): + ask (and
//       + 1 to the job count) on a taken row, + 0.0 on a round's winner
//       not taken (K3 adds 0.0f), + ask * 0.0 on a sequence step's
//       winner not taken (K2 adds ask * 0.0); then, on the rows it has
//       just updated, the step's ask scored (score_node, K1) and the
//       shard's best k (score, global index) pairs in the order of
//       K3's top-k (score descending, -0.0 tied with 0.0, then index
//       ascending): a block argmax for k = 1 (the sequence walks), K3's
//       select_topk or full sort for k = min(k_cap, R) (the rounds)
//       (K7a).  The walk's first step selects only; its tail, after the
//       last step, applies only, so the returned usage holds the last
//       winners;
//   K7b merge_select_kernel, on the lead device, one block a lane: the
//       global top kout of the S sorted lists, each candidate placed at
//       its rank (its position in its own list plus, per other list, a
//       binary search for the keys above it: keys are distinct, global
//       indices being); what K2/K3 keep of it (the sequence walk:
//       valid & best > -1e30/2; the rounds: pos < m & vals > -1e30/2,
//       m -= placed, m carried on the device from round to round); the
//       step's chosen and scores where K2-K4 put them; and for every
//       shard the rows it owns to update, (local row << 1 | taken) or -1.
//
// A lane's winners are distinct rows, so every row gets the same adds in
// the same order as in the unsharded kernels, and the walks equal them
// bit for bit.  Each lane evolves its own usage and job counts on every
// shard, from a copy of the shared base (the vmap's carry in K4a/K4b).
// The global top k_cap of the rounds is the merge of each shard's top
// min(k_cap, R) in the same total order, whatever ties straddle a shard
// edge, and a shard of fewer rows than k_cap hands in all of them (S * R
// = N >= k_cap).
//
// Bound on an H100: a step reads each shard's R rows of fleet state once
// and writes the winners' rows: at config 4 (N = 16,384 over 4 shards,
// one round of k_cap = 1,024) a few hundred kilobytes, well under a
// microsecond.  What bounds a walk is its chain of launches, each
// enqueued by the host and waiting on the one before it.  The first
// port took 2 S + 1 launches a step (K7a and K7c on every shard, K7b);
// shard_step_kernel takes every shard of a card in one launch and folds
// K7c into the next step's select, so a step on one card is two
// launches (S + 1 on S cards), plus one tail a walk.  Its per-shard
// pointers travel by value (StepTable, up to MAX_STEP_SHARDS shards a
// launch), set up once per walk by the host.  Where every shard of a row
// sits on one card, shard_walk_kernel (below) runs the whole walk in one
// launch instead; shard_step_kernel and K7b stay for rows whose shards
// span cards.

// Shards of one mesh row that one shard_step launch takes.
#define MAX_STEP_SHARDS 16

// One shard's operands of shard_step_kernel (R = rows, B = lanes).
// The host passes them as STEP_WORDS 64-bit words a shard, in this
// order (nomad_tpu_torch/ops/binpack.py STEP_FIELDS).
struct StepShard {
  const float* cap;         // [R][NDIMS]
  const float* res;         // [R][NDIMS]
  float* usage;             // [B][R][NDIMS], updated in place
  int* jc;                  // [B][R], updated in place
  const uint8_t* feas;      // [B][g_len][R]
  const float* asks;        // [B][g_len][NDIMS]
  const uint8_t* distinct;  // [B][g_len]
  const float* penalty;     // [B]
  const int* group_idx;     // [B][p_len]; null in a rounds walk
  float* out_v;             // [B][k], the shard's sorted candidates
  int* out_i;               // [B][k], their global indices
  const int* upd;           // [B][kout], K7b's updates for this shard
  uint32_t* scratch;        // [B][key_words] key regions, or null
  long long row_lo;         // the shard's first row in the fleet
};
#define STEP_WORDS 14

struct StepTable {
  StepShard s[MAX_STEP_SHARDS];
};

// K7a+c on one (lane, shard) block: apply_step >= 0 applies the shard's
// updates of that step (its ask: slot apply_step of a rounds walk, or
// group group_idx[b][apply_step] of a sequence walk); select_step >= 0
// then writes the shard's best k for that step's ask into out_v /
// out_i [b][k], sorted; a value is the score as K1 computed it (k = 1)
// or as K3's keys hold it (k > 1: -0.0 as 0.0).
__global__ void __launch_bounds__(THREADS) shard_step_kernel(
    const StepTable table, int rows, int g_len, int p_len, int apply_step,
    int select_step, int k, int kout, int path, int key_words) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ float s_ask[NDIMS];
  __shared__ float s_v[WARPS];
  __shared__ int s_i[WARPS];
  __shared__ int s_hist[RADIX_BINS];
  __shared__ int s_cnt[2][WARPS];
  __shared__ TopkSel s_sel;
  const StepShard sh = table.s[blockIdx.y];
  const size_t b = blockIdx.x;
  const size_t rr = (size_t)rows;
  const bool seq = sh.group_idx != nullptr;
  float* u = sh.usage + b * rr * NDIMS;
  int* j = sh.jc + b * rr;
  if (apply_step >= 0) {
    // K7c: a lane's winners are distinct rows, so no two threads write
    // one row.
    const int g = seq ? sh.group_idx[b * p_len + apply_step] : apply_step;
    const float* ask = sh.asks + (b * g_len + g) * NDIMS;
    const int* e_row = sh.upd + b * kout;
    for (int t = threadIdx.x; t < kout; t += THREADS) {
      const int e = e_row[t];
      if (e < 0) continue;
      const size_t row = (size_t)(e >> 1);
      const bool take = (e & 1) != 0;
      float* ur = u + row * NDIMS;
#pragma unroll
      for (int d = 0; d < NDIMS; ++d)
        ur[d] = __fadd_rn(ur[d], take ? ask[d]
                                      : (seq ? __fmul_rn(ask[d], 0.0f)
                                             : 0.0f));
      if (take) j[row] += 1;
    }
    if (select_step < 0) return;  // the walk's tail
    __syncthreads();  // the select reads the rows just written
  }
  // K7a.
  const int g = seq ? sh.group_idx[b * p_len + select_step] : select_step;
  const size_t lg = b * g_len + g;
  if (threadIdx.x < NDIMS)
    s_ask[threadIdx.x] = sh.asks[lg * NDIMS + threadIdx.x];
  __syncthreads();
  const uint8_t* f = sh.feas + lg * rr;
  const bool dist = sh.distinct[lg] != 0;
  const float pen = sh.penalty[b];
  const int row_lo = (int)sh.row_lo;
  if (k == 1) {
    // Threads past the last row hold -inf at index INT_MAX: below every
    // row's score (-1e30 at the least).
    float v = __int_as_float(0xff800000);
    int i = 0x7fffffff;
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      const float sc = score_node(sh.cap, sh.res, u, j, s_ask, f, dist, pen,
                                  r);
      if (better(sc, r, v, i)) {
        v = sc;
        i = r;
      }
    }
    block_argmax(v, i, s_v, s_i);
    if (threadIdx.x == 0) {
      sh.out_v[b] = v;
      sh.out_i[b] = row_lo + i;
    }
    return;
  }
  void* keys = sh.scratch != nullptr
                   ? (void*)(sh.scratch + b * (size_t)key_words)
                   : (void*)s_keys;
  unsigned long long* keys64 = reinterpret_cast<unsigned long long*>(keys);
  if (path == TOPK_SELECT) {
    select_topk(sh.cap, sh.res, u, j, s_ask, f, dist, pen, rows, k, keys,
                s_hist, &s_sel, s_cnt);
  } else {
    for (int r = threadIdx.x; r < rows; r += THREADS)
      keys64[r] = sort_key(ordered_bits(score_node(sh.cap, sh.res, u, j,
                                                   s_ask, f, dist, pen, r)),
                           r);
    __syncthreads();
    bitonic_sort_desc(keys64, rows);
  }
  for (int t = threadIdx.x; t < k; t += THREADS) {
    const unsigned long long key = keys64[t];
    sh.out_v[b * k + t] = from_ordered((uint32_t)(key >> 32));
    sh.out_i[b * k + t] = row_lo + (int)(~(uint32_t)(key & 0xffffffffull));
  }
}

// The 64-bit key of a K7 candidate: K3's order (ordered score bits, then
// the inverted global index).
__device__ __forceinline__ unsigned long long cand_key(const float* v,
                                                       const int* i,
                                                       size_t at) {
  return sort_key(ordered_bits(v[at]), i[at]);
}

// K7b: per lane, the global top kout of the shards' sorted lists
// cand_v / cand_i [shards][lanes][k], and what the walk keeps of them.
// seq: the sequence step `slot` (chosen / scores [lanes][out_len], valid
// [lanes][out_len], kout = 1); else round `rnd` of slot `slot` (chosen /
// scores [lanes][g_len][out_len], out_len = rounds * kout, counts
// [lanes][g_len]; m [lanes] the copies left, read from counts at round
// 0).  upd [shards][lanes][kout] gets, per shard, the local row and the
// taken bit of each winner it owns, -1 elsewhere; a shard owns rows
// [s * rows, (s + 1) * rows).
__global__ void __launch_bounds__(THREADS) merge_select_kernel(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i,
    int shards, int lanes, int k, int kout, int rows, int seq, int slot,
    int rnd, int g_len, int out_len, const int* __restrict__ counts,
    const uint8_t* __restrict__ valid, int* m, int* __restrict__ upd,
    int* __restrict__ chosen, float* __restrict__ scores) {
  const size_t b = blockIdx.x;
  const size_t list = (size_t)lanes * k;  // one shard's lists
  int left = 0;  // copies left (rounds) / the step's valid flag (seq)
  if (seq)
    left = valid[b * out_len + slot] != 0;
  else
    left = rnd == 0 ? counts[b * g_len + slot] : m[b];
  const size_t base = seq ? b * out_len + slot
                          : (b * g_len + slot) * out_len + (size_t)rnd * kout;
  int placed = 0;
  const int total = shards * k;
  for (int t0 = 0; t0 < total; t0 += THREADS) {
    const int t = t0 + threadIdx.x;
    bool take = false;
    if (t < total) {
      const int s = t / k;
      const int jj = t % k;
      const size_t at = s * list + b * k + jj;
      const unsigned long long key = cand_key(cand_v, cand_i, at);
      int rank = jj;
      for (int o = 0; o < shards && rank < kout; ++o) {
        if (o == s) continue;
        // Keys of list o above `key`: a lower bound in a descending list.
        const size_t lo0 = o * list + b * k;
        int lo = 0, hi = k;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cand_key(cand_v, cand_i, lo0 + mid) > key)
            lo = mid + 1;
          else
            hi = mid;
        }
        rank += lo;
      }
      if (rank < kout) {
        const int idx = cand_i[at];
        const float val =
            seq ? cand_v[at] : from_ordered((uint32_t)(key >> 32));
        take = (seq ? left != 0 : rank < left) && val > NEG_INF / 2;
        chosen[base + rank] = take ? idx : -1;
        scores[base + rank] = val;
        const int owner = idx / rows;
        for (int o = 0; o < shards; ++o)
          upd[((size_t)o * lanes + b) * kout + rank] =
              o == owner ? (((idx - o * rows) << 1) | (take ? 1 : 0)) : -1;
      }
    }
    placed += __syncthreads_count(take);
  }
  if (!seq && threadIdx.x == 0) m[b] = left - placed;
}

// K7a+b+c on one card: shard_walk_kernel.
//
// Where every shard of a mesh row sits on one card, a whole sharded walk
// is ONE launch: a thread-block cluster a lane, whose CTAs are the row's
// shards (CTA s owns rows [s R, (s + 1) R), R = rows, and its StepShard
// fields come by value, as WalkShard), and a loop over the walk's steps
// inside it.  A step:
//
//   1. select: the step's ask scored on the CTA's rows and its best k, as
//      shard_step_kernel selects them (the block argmax for k = 1, K3's
//      select_topk or full sort for k > 1; the keys then rewritten from
//      local to global indices in place, which keeps their order);
//   2. a cluster barrier;
//   3. merge, in distributed shared memory, to the specification of K7b:
//      k = 1: warp 0 of every CTA reduces the cluster's S bests, one
//      DSMEM load a lane, in the order of K7b's 64-bit key (ordered score
//      bits, then the inverted global index); k > 1: each CTA ranks its
//      own candidates against every other CTA's sorted list (a binary
//      search of each, probing the other CTA's keys in place: its shared
//      memory, or its device scratch where select_topk keeps the keys
//      there).  A winner's chosen and score go where K2-K4 put them, and
//      the CTA that owns its row applies it at once (K7c's adds,
//      unchanged: + ask and + 1 job on a taken row, + 0.0 on a round's
//      winner not taken, + ask * 0.0 on a sequence step's), so the
//      winners never leave the CTA and no update buffer exists;
//   4. k > 1: a second cluster barrier (every list has been read before
//      the next select overwrites it), then the round's takes summed
//      over the cluster from each CTA's shared memory: the copies left,
//      m.  k = 1 keeps each step's best in one of two slots by step
//      parity, so its one barrier a step suffices: a CTA writes a slot
//      again two steps later, after every CTA has passed the barrier of
//      the step between, and so has read it.
//
// A winner is applied before the CTA's next select reads its rows, and a
// lane's winners are distinct rows, so every row gets the adds of
// shard_step + K7b in the same order: the walk equals K2/K3/K4a/K4b bit
// for bit.  A last cluster barrier keeps every CTA's shared memory alive
// until the others have read it.
//
// Bound on an H100: the function is K2's, K3's, K4a's or K4b's (a few
// microseconds of bytes and operations at the main path's shapes).  What
// bounded the two launches a step of shard_step + K7b was the host's
// launch interval; here a step is the CTAs' select and one or two
// cluster barriers.  The select scores the shard's R rows at every step
// (where K2 rescored one node), which bounds a sequence step at large R.
#define WALK_WORDS 11

struct WalkShard {
  const float* cap;         // [R][NDIMS]
  const float* res;         // [R][NDIMS]
  float* usage;             // [B][R][NDIMS], updated in place
  int* jc;                  // [B][R], updated in place
  const uint8_t* feas;      // [B][g_len][R]
  const float* asks;        // [B][g_len][NDIMS]
  const uint8_t* distinct;  // [B][g_len]
  const float* penalty;     // [B]
  const int* group_idx;     // [B][p_len]; null in a rounds walk
  uint32_t* scratch;        // [B][key_words] key regions, or null
  long long row_lo;         // the shard's first row: rank * R
};

struct WalkTable {
  WalkShard s[MAX_STEP_SHARDS];
};

// One cluster of `shards` CTAs a lane (grid lanes * shards); chosen /
// scores / valid / counts on the card, shaped as merge_select_kernel
// reads and writes them (seq: [B][p_len]; rounds: [B][g_len][rounds *
// kout], counts [B][g_len]).  k = 1: the argmax (a sequence walk, or
// rounds of k_cap = 1); else k = min(k_cap, R) and the top-k `path`.
__global__ void __launch_bounds__(THREADS, 1) shard_walk_kernel(
    const WalkTable table, int rows, int g_len, int p_len, int k, int kout,
    int rounds, int path, int key_words, int* __restrict__ chosen,
    float* __restrict__ scores, const uint8_t* __restrict__ valid,
    const int* __restrict__ counts) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ float s_ask[NDIMS];
  __shared__ float s_v[WARPS];
  __shared__ int s_i[WARPS];
  __shared__ int s_hist[RADIX_BINS];
  __shared__ int s_cnt[2][WARPS];
  __shared__ TopkSel s_sel;
  __shared__ uint2 s_best[2];  // k = 1: (score bits, global index)
  __shared__ int s_taken;      // k > 1: the CTA's takes in the round
  __shared__ int s_left;
  cg::cluster_group cluster = cg::this_cluster();
  const int shards = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const WalkShard sh = table.s[rank];
  const size_t b = blockIdx.x / shards;
  const size_t rr = (size_t)rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool seq = sh.group_idx != nullptr;
  float* u = sh.usage + b * rr * NDIMS;
  int* j = sh.jc + b * rr;
  const int row_lo = (int)sh.row_lo;
  const float pen = sh.penalty[b];
  const int steps = seq ? p_len : g_len * rounds;
  const size_t out_len = seq ? (size_t)p_len : (size_t)rounds * kout;
  unsigned long long* keys64 =
      sh.scratch != nullptr
          ? reinterpret_cast<unsigned long long*>(sh.scratch +
                                                  b * (size_t)key_words)
          : s_keys;
  int left = 0;  // a rounds walk's copies left in the slot
  for (int t = 0; t < steps; ++t) {
    const int slot = seq ? t : t / rounds;
    const int rnd = seq ? 0 : t % rounds;
    const int g = seq ? sh.group_idx[b * p_len + t] : slot;
    const size_t lg = b * g_len + g;
    if (!seq && rnd == 0) left = counts[b * g_len + slot];
    // The step before has applied its winner(s) and met a barrier.
    if (tid < NDIMS) s_ask[tid] = sh.asks[lg * NDIMS + tid];
    __syncthreads();
    const uint8_t* f = sh.feas + lg * rr;
    const bool dist = sh.distinct[lg] != 0;
    const size_t base = seq ? b * out_len + t
                            : (b * g_len + slot) * out_len +
                                  (size_t)rnd * kout;
    if (k == 1) {
      // 1. The shard's best; threads past the last row hold -inf at
      // index INT_MAX.
      float v = __int_as_float(0xff800000);
      int i = 0x7fffffff;
      for (int r = tid; r < rows; r += THREADS) {
        const float sc =
            score_node(sh.cap, sh.res, u, j, s_ask, f, dist, pen, r);
        if (better(sc, r, v, i)) {
          v = sc;
          i = r;
        }
      }
      block_argmax(v, i, s_v, s_i);
      const int par = t & 1;
      if (tid == 0)
        s_best[par] = make_uint2(__float_as_uint(v), (uint32_t)(row_lo + i));
      // 2.
      cluster_arrive_release();
      cluster_wait_acquire();
      // 3. The cluster's best, by warp 0 of every CTA.
      if (warp == 0) {
        float wv = __int_as_float(0xff800000);
        int wi = 0x7fffffff;
        if (lane < shards) {
          const uint2 x = *cluster.map_shared_rank(&s_best[par], lane);
          wv = __uint_as_float(x.x);
          wi = (int)x.y;
        }
        warp_argmax(wv, wi);
        const float val = seq ? wv : from_ordered(ordered_bits(wv));
        const bool take = (seq ? valid[b * out_len + t] != 0 : left > 0) &&
                          val > NEG_INF / 2;
        if (rank == 0 && lane == 0) {
          chosen[base] = take ? wi : -1;
          scores[base] = val;
        }
        const int li = wi - row_lo;
        if (lane == 0 && li >= 0 && li < rows) {
          float* ur = u + (size_t)li * NDIMS;
#pragma unroll
          for (int d = 0; d < NDIMS; ++d)
            ur[d] = __fadd_rn(ur[d], take ? s_ask[d]
                                          : (seq ? __fmul_rn(s_ask[d], 0.0f)
                                                 : 0.0f));
          if (take) j[li] += 1;
        }
        left -= take ? 1 : 0;  // warp 0's copy is the one read (k = 1)
      }
      __syncthreads();  // the next select reads the row just written
      continue;
    }
    // 1. The shard's best k, sorted, as 64-bit keys with global indices.
    if (path == TOPK_SELECT) {
      select_topk(sh.cap, sh.res, u, j, s_ask, f, dist, pen, rows, k,
                  keys64, s_hist, &s_sel, s_cnt);
    } else {
      for (int r = tid; r < rows; r += THREADS)
        keys64[r] = sort_key(ordered_bits(score_node(sh.cap, sh.res, u, j,
                                                     s_ask, f, dist, pen, r)),
                             r);
      __syncthreads();
      bitonic_sort_desc(keys64, rows);
    }
    for (int x = tid; x < k; x += THREADS) {
      const unsigned long long key = keys64[x];
      const int local = (int)(~(uint32_t)(key & 0xffffffffull));
      keys64[x] = (key & 0xffffffff00000000ull) |
                  (unsigned long long)(~(uint32_t)(row_lo + local));
    }
    // 2.
    cluster_arrive_release();
    cluster_wait_acquire();
    // 3. Each own candidate's rank among the cluster's: its position in
    // its list plus, for every other list, the keys above it (keys are
    // distinct: their global indices are).
    int taken = 0;
    for (int x0 = 0; x0 < k; x0 += THREADS) {
      const int x = x0 + tid;
      bool take = false;
      if (x < k) {
        const unsigned long long key = keys64[x];
        int at = x;
        for (int o = 0; o < shards && at < kout; ++o) {
          if (o == rank) continue;
          const unsigned long long* other =
              sh.scratch != nullptr
                  ? reinterpret_cast<const unsigned long long*>(
                        table.s[o].scratch + b * (size_t)key_words)
                  : cluster.map_shared_rank(s_keys, o);
          int lo = 0, hi = k;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (other[mid] > key)
              lo = mid + 1;
            else
              hi = mid;
          }
          at += lo;
        }
        if (at < kout) {
          const int idx = (int)(~(uint32_t)(key & 0xffffffffull));
          const float val = from_ordered((uint32_t)(key >> 32));
          take = at < left && val > NEG_INF / 2;
          chosen[base + at] = take ? idx : -1;
          scores[base + at] = val;
          // This CTA owns the winner's row; no two threads share one.
          const size_t li = (size_t)(idx - row_lo);
          float* ur = u + li * NDIMS;
#pragma unroll
          for (int d = 0; d < NDIMS; ++d)
            ur[d] = __fadd_rn(ur[d], take ? s_ask[d] : 0.0f);
          if (take) j[li] += 1;
        }
      }
      taken += __syncthreads_count(take);
    }
    if (tid == 0) s_taken = taken;
    // 4. Every list read, every CTA's takes counted.
    cluster_arrive_release();
    cluster_wait_acquire();
    if (warp == 0) {
      int sum = lane < shards ? *cluster.map_shared_rank(&s_taken, lane) : 0;
      sum = __reduce_add_sync(FULL_MASK, sum);
      if (lane == 0) s_left = left - sum;
    }
    __syncthreads();
    left = s_left;
  }
  // No CTA leaves while another may still read its shared memory.
  cluster_arrive_release();
  cluster_wait_acquire();
}

extern "C" {

const char* nomad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K2's plan for n nodes (a power of two) and g_len groups on the current
// device: out[0] the cluster's CTAs (sequence_csize), out[1] the score
// slots a CTA keeps (g_len up to MAX_SLOTS, else 1: without a slot per
// group, every group change rescores the fleet), out[2] SEQ_SHARED
// where its shared memory fits, else SEQ_SCRATCH (a device scratch of
// slots * n floats).  Returns a CUDA error code;
// cudaErrorInvalidConfiguration when no cluster size can launch.
int nomad_place_sequence_plan(int n, int g_len, int* out) {
  if (n < 1 || (n & (n - 1)) != 0 || g_len < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = sequence_attributes(place_sequence_kernel);
  if (e != cudaSuccess) return (int)e;
  const int slots = g_len <= MAX_SLOTS ? g_len : 1;
  const int csize = sequence_csize(place_sequence_kernel, n, slots);
  if (csize < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = csize;
  out[1] = slots;
  out[2] = sequence_mode((size_t)(n / csize), slots);
  return 0;
}

// K4b's plan for `lanes` lanes of n nodes and g_len groups: out[0..2] as
// nomad_place_sequence_plan's, for the cluster of each lane.  The rule:
// start from K2's cluster and halve it until the lanes' clusters fit one
// wave (cudaOccupancyMaxActiveClusters >= lanes) or it is one CTA.
// Measured on an H100 against the other shape, K2's cluster with the
// lanes in waves (chip_smoke.py, N = 16,384, 8 groups): at B = 8, P = 256
// one wave of 8-CTA clusters with their slots in device memory took
// 0.551 ms against 0.786 for 16-CTA clusters in shared memory (8 of them
// do not fit at once); at B = 64, P = 64, one wave of 2-CTA clusters
// 0.305 ms against 1.355 for waves of 16-CTA clusters.  A lane's steps
// are a chain, so a second wave costs a whole lane's time, and that
// outweighs a step's slower rescoring from device memory.
int nomad_place_sequence_batch_plan(int n, int g_len, int lanes, int* out) {
  if (n < 1 || (n & (n - 1)) != 0 || g_len < 1 || lanes < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = sequence_attributes(place_sequence_batch_kernel);
  if (e != cudaSuccess) return (int)e;
  const int slots = g_len <= MAX_SLOTS ? g_len : 1;
  int csize = sequence_csize(place_sequence_batch_kernel, n, slots);
  if (csize < 1) return (int)cudaErrorInvalidConfiguration;
  while (csize > 1 &&
         sequence_clusters(place_sequence_batch_kernel, n, csize, slots) <
             lanes)
    csize >>= 1;
  out[0] = csize;
  out[1] = slots;
  out[2] = sequence_mode((size_t)(n / csize), slots);
  return 0;
}

// K2 with a plan of nomad_place_sequence_plan for (n, g_len).
int nomad_place_sequence(const float* cap, const float* res,
                         const float* usage0, const int* jc0,
                         const uint8_t* feas, const float* asks,
                         const uint8_t* distinct, const int* group_idx,
                         const uint8_t* valid, float penalty, int n, int g_len,
                         int p_len, int csize, int slots, int mode,
                         int* chosen, float* scores, float* usage, int* jc,
                         float* scratch, void* stream) {
  if (csize < 1 || csize > MAX_CLUSTER || (csize & (csize - 1)) != 0 ||
      n % csize != 0 || (slots != 1 && slots != g_len) || slots > MAX_SLOTS ||
      mode < SEQ_SHARED || mode > SEQ_SCRATCH ||
      (mode == SEQ_SCRATCH) != (scratch != nullptr) ||
      sequence_smem((size_t)(n / csize), slots, mode) > CACHE_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      sequence_config(n, csize, slots, mode, 1, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, place_sequence_kernel, cap, res, usage0, jc0, feas, asks,
      distinct, group_idx, valid, penalty, n, g_len, p_len, slots, mode,
      chosen, scores, usage, jc, scratch);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// K3/K4a's plan for n nodes (a power of two) and k_cap: out[0] the
// top-k path (`path`, or topk_path's rule where it is -1), out[1] the
// 32-bit words of one lane's key region, out[2] 1 where that region
// lies in shared memory, else 0 (the caller passes a scratch of out[1]
// words a lane).  Returns a CUDA error code.
int nomad_place_rounds_plan(int n, int k_cap, int path, int* out) {
  if (n < 1 || (n & (n - 1)) != 0 || k_cap < 1 || k_cap > n || path < -1 ||
      path > TOPK_SELECT || (path == TOPK_SELECT && n < 4))
    return (int)cudaErrorInvalidValue;
  if (path < 0) path = topk_path(n, k_cap);
  const size_t bytes = topk_key_bytes(n, k_cap, path);
  out[0] = path;
  out[1] = (int)(bytes / 4);
  out[2] = bytes <= KEYS_SMEM_MAX ? 1 : 0;
  return 0;
}

static bool rounds_args_ok(int n, int k_cap, int rounds, int path) {
  return n >= 1 && (n & (n - 1)) == 0 && k_cap >= 1 && k_cap <= n &&
         rounds >= 1 && path >= TOPK_SORT && path <= TOPK_SELECT &&
         (path == TOPK_SORT || n >= 4);
}

int nomad_place_rounds(const float* cap, const float* res, const float* usage0,
                       const int* jc0, const uint8_t* feas, const float* asks,
                       const uint8_t* distinct, const int* counts,
                       float penalty, int n, int g_len, int k_cap, int rounds,
                       int path, int* chosen, float* scores, float* usage,
                       int* jc, uint32_t* scratch, void* stream) {
  if (!rounds_args_ok(n, k_cap, rounds, path))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int e = keys_smem(place_rounds_kernel,
                          topk_key_bytes(n, k_cap, path), scratch, &smem);
  if (e != 0) return e;
  place_rounds_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      cap, res, usage0, jc0, feas, asks, distinct, counts, penalty, n, g_len,
      k_cap, rounds, path, chosen, scores, usage, jc, scratch);
  return (int)cudaGetLastError();
}

// K4b with a plan of nomad_place_sequence_batch_plan for (n, g_len,
// lanes); `scratch` (lanes * slots * n floats) in mode SEQ_SCRATCH.
int nomad_place_sequence_batch(
    const float* cap, const float* res, const float* usage0, const int* jc0,
    const uint8_t* feas, const float* asks, const uint8_t* distinct,
    const int* group_idx, const uint8_t* valid, const float* penalty,
    int lanes, int n, int g_len, int p_len, int csize, int slots, int mode,
    int* chosen, float* scores, float* usage, int* jc, float* scratch,
    void* stream) {
  if (lanes < 1 || csize < 1 || csize > MAX_CLUSTER ||
      (csize & (csize - 1)) != 0 || n % csize != 0 ||
      (slots != 1 && slots != g_len) || slots > MAX_SLOTS ||
      mode < SEQ_SHARED || mode > SEQ_SCRATCH ||
      (mode == SEQ_SCRATCH) != (scratch != nullptr) ||
      sequence_smem((size_t)(n / csize), slots, mode) > CACHE_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      sequence_config(n, csize, slots, mode, lanes, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, place_sequence_batch_kernel, cap, res, usage0, jc0, feas, asks,
      distinct, group_idx, valid, penalty, n, g_len, p_len, slots, mode,
      chosen, scores, usage, jc, scratch);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

int nomad_place_rounds_batch(
    const float* cap, const float* res, const float* usage0, const int* jc0,
    const uint8_t* feas, const float* asks, const uint8_t* distinct,
    const int* counts, const float* penalty, int lanes, int n, int g_len,
    int k_cap, int rounds, int path, int* chosen, float* scores,
    float* usage, int* jc, uint32_t* scratch, void* stream) {
  if (lanes < 1 || !rounds_args_ok(n, k_cap, rounds, path))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = topk_key_bytes(n, k_cap, path);
  size_t smem = 0;
  const int e = keys_smem(place_rounds_batch_kernel, bytes, scratch, &smem);
  if (e != 0) return e;
  place_rounds_batch_kernel<<<lanes, THREADS, smem, (cudaStream_t)stream>>>(
      cap, res, usage0, jc0, feas, asks, distinct, counts, penalty, n, g_len,
      k_cap, rounds, path, (int)(bytes / 4), chosen, scores, usage, jc,
      scratch);
  return (int)cudaGetLastError();
}

// K7a+c on `shards` shards of one mesh row on the current card, `lanes`
// lanes each, every shard of `rows` rows (a power of two where k > 1);
// `table` holds STEP_WORDS host words a shard (StepShard's fields in
// order).  apply_step / select_step as in the kernel, -1 for none (not
// both).  k = 1: the block argmax; else the top-k path `path` of
// nomad_place_rounds_plan(rows, k), every shard's key regions in shared
// memory or all in their `scratch` (key words a lane as that plan's).
int nomad_shard_step(const unsigned long long* table, int shards, int lanes,
                     int rows, int g_len, int p_len, int apply_step,
                     int select_step, int k, int kout, int path,
                     void* stream) {
  if (table == nullptr || shards < 1 || shards > MAX_STEP_SHARDS ||
      lanes < 1 || rows < 1 || g_len < 1 || kout < 1 || k < 1 || k > rows ||
      apply_step < -1 || select_step < -1 ||
      (apply_step < 0 && select_step < 0) ||
      (select_step >= 0 && k > 1 && !rounds_args_ok(rows, k, 1, path)))
    return (int)cudaErrorInvalidValue;
  StepTable t;
  const bool seq = table[8] != 0ull;
  const bool scratch = table[12] != 0ull;
  const int steps = seq ? p_len : g_len;
  if (apply_step >= steps || select_step >= steps)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < shards; ++s) {
    const unsigned long long* w = table + (size_t)s * STEP_WORDS;
    for (int f = 0; f < 8; ++f)
      if (w[f] == 0ull) return (int)cudaErrorInvalidValue;
    if ((w[8] != 0ull) != seq || (w[12] != 0ull) != scratch ||
        (select_step >= 0 && (w[9] == 0ull || w[10] == 0ull)) ||
        (apply_step >= 0 && w[11] == 0ull))
      return (int)cudaErrorInvalidValue;
    StepShard& x = t.s[s];
    x.cap = (const float*)w[0];
    x.res = (const float*)w[1];
    x.usage = (float*)w[2];
    x.jc = (int*)w[3];
    x.feas = (const uint8_t*)w[4];
    x.asks = (const float*)w[5];
    x.distinct = (const uint8_t*)w[6];
    x.penalty = (const float*)w[7];
    x.group_idx = (const int*)w[8];
    x.out_v = (float*)w[9];
    x.out_i = (int*)w[10];
    x.upd = (const int*)w[11];
    x.scratch = (uint32_t*)w[12];
    x.row_lo = (long long)w[13];
  }
  size_t smem = 0;
  size_t bytes = 0;
  if (select_step >= 0 && k > 1) {
    bytes = topk_key_bytes(rows, k, path);
    const int e = keys_smem(shard_step_kernel, bytes,
                            scratch ? (const void*)table[12] : nullptr,
                            &smem);
    if (e != 0) return e;
  }
  shard_step_kernel<<<dim3(lanes, shards), THREADS, smem,
                      (cudaStream_t)stream>>>(
      t, rows, g_len, p_len, apply_step, select_step, k, kout, path,
      (int)(bytes / 4));
  return (int)cudaGetLastError();
}

// K7b over `shards` lists of k candidates per lane; see the kernel.
int nomad_merge_select(const float* cand_v, const int* cand_i, int shards,
                       int lanes, int k, int kout, int rows, int seq,
                       int slot, int rnd, int g_len, int out_len,
                       const int* counts, const uint8_t* valid, int* m,
                       int* upd, int* chosen, float* scores, void* stream) {
  if (shards < 1 || lanes < 1 || k < 1 || kout < 1 || kout > shards * k ||
      rows < 1 || slot < 0 || rnd < 0 ||
      (seq ? (kout != 1 || valid == nullptr || slot >= out_len)
           : (counts == nullptr || m == nullptr || slot >= g_len ||
              (size_t)(rnd + 1) * kout > (size_t)out_len)))
    return (int)cudaErrorInvalidValue;
  merge_select_kernel<<<lanes, THREADS, 0, (cudaStream_t)stream>>>(
      cand_v, cand_i, shards, lanes, k, kout, rows, seq, slot, rnd, g_len,
      out_len, counts, valid, m, upd, chosen, scores);
  return (int)cudaGetLastError();
}

// The launch configuration of shard_walk_kernel: `lanes` clusters of
// `shards` CTAs, with `smem` bytes of keys a CTA in shared memory.
static cudaLaunchConfig_t walk_config(int shards, int lanes, size_t smem,
                                      void* stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shards * lanes, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = shards;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Shared-memory bytes of one shard_walk CTA's keys (0 where k = 1 or the
// keys lie in the caller's scratch).
static size_t walk_smem(int rows, int k, int path) {
  if (k == 1) return 0;
  const size_t bytes = topk_key_bytes(rows, k, path);
  return bytes <= KEYS_SMEM_MAX ? bytes : 0;
}

// shard_walk's plan for `shards` shards of `rows` rows and k candidates
// a shard (path as nomad_place_rounds_plan's for k > 1): raises the
// kernel's attributes on the current device (clusters above 8 CTAs,
// shared memory past 48 KB) and writes out[0], the clusters of `shards`
// CTAs the card runs at once (cudaOccupancyMaxActiveClusters).  Returns a
// CUDA error code; cudaErrorInvalidConfiguration where not one cluster
// fits.
int nomad_shard_walk_plan(int shards, int rows, int k, int path, int* out) {
  if (shards < 1 || shards > MAX_STEP_SHARDS || rows < 1 || k < 1 ||
      k > rows || (k > 1 && !rounds_args_ok(rows, k, 1, path)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      shard_walk_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(shard_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KEYS_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      walk_config(shards, 1, walk_smem(rows, k, path), nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, shard_walk_kernel, &cfg);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)e;
  }
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = clusters;
  return 0;
}

// A whole sharded walk of one mesh row whose `shards` shards all sit on
// the current card, after nomad_shard_walk_plan for (shards, rows, k,
// path): `table` holds WALK_WORDS host words a shard (WalkShard's fields
// in order; shard s's row_lo s * rows), `lanes` lanes each; kout winners
// a step; chosen / scores / valid (a sequence walk) or counts (rounds) as
// the kernel takes them.  Where k > 1 and the keys do not fit shared
// memory, every shard passes its scratch of key words a lane (those of
// nomad_place_rounds_plan(rows, k)); otherwise none does.
int nomad_shard_walk(const unsigned long long* table, int shards, int lanes,
                     int rows, int g_len, int p_len, int k, int kout,
                     int rounds, int path, int* chosen, float* scores,
                     const uint8_t* valid, const int* counts, void* stream) {
  if (table == nullptr || shards < 1 || shards > MAX_STEP_SHARDS ||
      lanes < 1 || rows < 1 || g_len < 1 || k < 1 || k > rows || kout < 1 ||
      (size_t)kout > (size_t)shards * k || rounds < 1 ||
      chosen == nullptr || scores == nullptr ||
      (k > 1 && !rounds_args_ok(rows, k, 1, path)))
    return (int)cudaErrorInvalidValue;
  const bool seq = table[8] != 0ull;
  const bool scratch = table[9] != 0ull;
  const size_t bytes = k > 1 ? topk_key_bytes(rows, k, path) : 0;
  if ((seq ? (k != 1 || kout != 1 || p_len < 1 || valid == nullptr)
           : counts == nullptr) ||
      scratch != (bytes > KEYS_SMEM_MAX))
    return (int)cudaErrorInvalidValue;
  WalkTable t;
  for (int s = 0; s < shards; ++s) {
    const unsigned long long* w = table + (size_t)s * WALK_WORDS;
    for (int f = 0; f < 8; ++f)
      if (w[f] == 0ull) return (int)cudaErrorInvalidValue;
    if ((w[8] != 0ull) != seq || (w[9] != 0ull) != scratch ||
        w[10] != (unsigned long long)s * (unsigned long long)rows)
      return (int)cudaErrorInvalidValue;
    WalkShard& x = t.s[s];
    x.cap = (const float*)w[0];
    x.res = (const float*)w[1];
    x.usage = (float*)w[2];
    x.jc = (int*)w[3];
    x.feas = (const uint8_t*)w[4];
    x.asks = (const float*)w[5];
    x.distinct = (const uint8_t*)w[6];
    x.penalty = (const float*)w[7];
    x.group_idx = (const int*)w[8];
    x.scratch = (uint32_t*)w[9];
    x.row_lo = (long long)w[10];
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = walk_config(
      shards, lanes, walk_smem(rows, k, path), stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, shard_walk_kernel, t, rows, g_len, p_len, k, kout, rounds, path,
      (int)(bytes / 4), chosen, scores, valid, counts);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
