// Placement kernels for the torch-binpack scheduler (sm_90a, plain C ABI).
//
// Replaces nomad_tpu/ops/binpack.py:
//   score_all_nodes  (K1)  -> score_values / score_node, __device__
//                             routines fused into every kernel below;
//   _place_sequence  (K2)  -> place_sequence_kernel, a thread-block
//                             cluster walking place_sequence_cluster_lane;
//   _place_rounds    (K3)  -> place_rounds_kernel;
//   place_rounds_batch    (K4a, a vmap of K3) -> place_rounds_batch_kernel;
//   place_sequence_batch  (K4b, a vmap of K2) -> place_sequence_batch_kernel.
//
// Two bodies for the sequence walk, until K4b moves onto a cluster per
// lane: K2 runs place_sequence_cluster_lane (below), K4b runs
// place_sequence_lane, one block per lane.  Both compute the same
// function (K4b's lanes are held against K2 bit for bit).  K3 and K4a
// share place_rounds_lane, one block per lane.  Each body is a
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
// step on the card (no launch per step, no host round trip).  K2 spreads
// the nodes of one walk over a cluster of up to 16 SMs that keeps a
// score slot per group current, so a placement rescores one node; K3/K4
// and K4b's lanes are one persistent block of 1,024 threads each,
// synchronised with __syncthreads between steps.
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
#define SMEM_SORT_MAX 16384  // keys sorted in shared memory up to this N
#define MAX_CLUSTER 16       // CTAs of one K2 cluster (non-portable above 8)
#define MAX_SLOTS WARPS      // score slots of one K2 CTA (a warp keeps each)
#define STEP_CHUNK 1024      // K2 steps staged in shared memory at a time
#define CACHE_SMEM_MAX (188 * 1024)  // K2's dynamic shared memory, bytes

// Where a K2 CTA keeps its node state and score slots.
#define SEQ_SHARED 0   // in shared memory
#define SEQ_SCRATCH 1  // in device memory (the slots in the scratch)

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

__device__ __forceinline__ void copy_state(
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    float* usage, int* jc, int n) {
  for (int i = threadIdx.x; i < n * NDIMS; i += THREADS) usage[i] = usage0[i];
  for (int i = threadIdx.x; i < n; i += THREADS) jc[i] = jc0[i];
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

// K4b body: K2 in one block of 1,024 threads, for one lane.  A step
// whose group equals the last scored step's, with no placement since,
// reuses that step's argmax (the state is unchanged but for +0.0 adds),
// so trailing padding costs one scoring, not one per step.
__device__ __forceinline__ void place_sequence_lane(
    const float* __restrict__ cap, const float* __restrict__ res,
    const float* __restrict__ usage0, const int* __restrict__ jc0,
    const uint8_t* __restrict__ feas, const float* __restrict__ asks,
    const uint8_t* __restrict__ distinct, const int* __restrict__ group_idx,
    const uint8_t* __restrict__ valid, float penalty, int n, int p_len,
    int* __restrict__ chosen, float* __restrict__ scores, float* usage,
    int* jc) {
  __shared__ float s_ask[NDIMS];
  __shared__ float s_val[WARPS];
  __shared__ int s_idx[WARPS];
  __shared__ int s_placed[2];  // by step parity: read while rewritten
  const int tid = threadIdx.x;
  copy_state(usage0, jc0, usage, jc, n);
  __syncthreads();
  int last_g = -1;      // group of the last scored step (uniform)
  bool placed = false;  // a placement since that step (uniform)
  float best = NEG_INF;
  int bi = 0;
  for (int p = 0; p < p_len; ++p) {
    const int g = group_idx[p];
    if (g != last_g || placed) {
      if (tid < NDIMS) s_ask[tid] = asks[g * NDIMS + tid];
      __syncthreads();
      const uint8_t* feas_g = feas + (size_t)g * n;
      const bool dist = distinct[g] != 0;
      best = __int_as_float(0xff800000);  // -inf
      bi = 0x7fffffff;
      for (int i = tid; i < n; i += THREADS) {
        const float s =
            score_node(cap, res, usage, jc, s_ask, feas_g, dist, penalty, i);
        if (s > best) {  // strided walk: the first max per thread is lowest
          best = s;
          bi = i;
        }
      }
      block_argmax(best, bi, s_val, s_idx);
      last_g = g;
    }
    if (tid == 0) {
      const bool ok = valid[p] && best > NEG_INF / 2;
      chosen[p] = ok ? bi : -1;
      scores[p] = best;
      add_step(usage + (size_t)bi * NDIMS, s_ask, ok);
      if (ok) jc[bi] += 1;
      s_placed[p & 1] = ok;
    }
    __syncthreads();
    placed = s_placed[p & 1] != 0;
  }
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
// up to min(remaining, k_cap) distinct winners; every winner not taken
// gets +0.0, as in the reference.  The top-k is a full sort of 64-bit
// keys (ordered score bits, inverted node index), so it returns the k
// largest with ties to the lower index, as lax.top_k.  A round after
// one that placed nothing reuses its sorted keys (the state changed
// only by +0.0 adds), so a slot's exhausted rounds cost one sort, and
// a slot with no feasible node neither a scoring nor a sort.
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
    bool sorted = false;  // keys hold this slot's order for the state
    for (int r = 0; r < rounds; ++r) {
      int* out_c = chosen + (size_t)s * stream_len + (size_t)r * k_cap;
      float* out_s = scores + (size_t)s * stream_len + (size_t)r * k_cap;
      if (!sorted) {  // uniform across the block
        // A slot with no feasible node (a padded slot) scores -1e30
        // everywhere: every key holds the same score word, so its first
        // k_cap keys in index order are its top-k (lower index first).
        bool any = false;
        for (int i = tid; i < n; i += THREADS) any = any || feas_s[i] != 0;
        if (__syncthreads_or(any)) {
          for (int i = tid; i < n; i += THREADS) {
            const float v = score_node(cap, res, usage, jc, s_ask, feas_s,
                                       dist, penalty, i);
            keys[i] = ((unsigned long long)ordered_bits(v) << 32) |
                      (unsigned long long)(~(uint32_t)i);
          }
          __syncthreads();
          bitonic_sort_desc(keys, n);
        } else {
          const unsigned long long none = (unsigned long long)ordered_bits(
                                              NEG_INF) << 32;
          for (int i = tid; i < k_cap; i += THREADS)
            keys[i] = none | (unsigned long long)(~(uint32_t)i);
          __syncthreads();
        }
        sorted = true;
      }
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


// The kernels.  Sort keys of N <= SMEM_SORT_MAX nodes live in the
// block's dynamic shared memory; above that, in the caller's scratch
// (one row of N keys per lane).
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
// Bound on an H100: at B = 8 lanes, N = 16,384, P = 256 the function
// needs one scoring of the fleet per group change and one node per
// placement in each lane, ~2 MB of distinct input.  What bounds it is
// each lane's chain of P dependent steps (~18 us a scored step on one
// SM); the lanes run side by side on their own SMs, so B <= 132 lanes
// take about the time of one.
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

// Dynamic shared memory of one K2 CTA with npc nodes: in SEQ_SHARED the
// node state (capacity, reserved, usage: 18 floats, a job count) and per
// slot the scores and the feasibility bytes; none in SEQ_SCRATCH.
static size_t sequence_smem(size_t npc, int slots, int mode) {
  if (mode == SEQ_SCRATCH) return 0;
  return npc * (3 * NDIMS + 1) * 4 + (size_t)slots * npc * 5;
}

// K2's launch configuration: one cluster of `csize` CTAs.
static cudaLaunchConfig_t sequence_config(int n, int csize, int slots,
                                          int mode, void* stream,
                                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 1, 1);
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

extern "C" {

const char* nomad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K2's plan for n nodes (a power of two) and g_len groups on the current
// device: out[0] the cluster's CTAs (n / 1,024 clamped to [1, 16], then
// halved until cudaOccupancyMaxActiveClusters finds room for one
// cluster), out[1] the score slots a CTA keeps (g_len up to MAX_SLOTS,
// else 1: without a slot per group, every group change rescores the
// fleet), out[2] SEQ_SHARED where its shared memory fits, else
// SEQ_SCRATCH (a device scratch of slots * n floats).
// Returns a
// CUDA error code; cudaErrorInvalidConfiguration when no cluster size
// can launch.
int nomad_place_sequence_plan(int n, int g_len, int* out) {
  if (n < 1 || (n & (n - 1)) != 0 || g_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      place_sequence_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(place_sequence_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CACHE_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  int csize = n / THREADS;
  csize = csize < 1 ? 1 : (csize > MAX_CLUSTER ? MAX_CLUSTER : csize);
  const int slots = g_len <= MAX_SLOTS ? g_len : 1;
  for (; csize >= 1; csize >>= 1) {
    const size_t npc = (size_t)(n / csize);
    const int mode = sequence_smem(npc, slots, SEQ_SHARED) <= CACHE_SMEM_MAX
                         ? SEQ_SHARED
                         : SEQ_SCRATCH;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        sequence_config(n, csize, slots, mode, nullptr, &attr);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, place_sequence_kernel, &cfg);
    if (e == cudaSuccess && clusters >= 1) {
      out[0] = csize;
      out[1] = slots;
      out[2] = mode;
      return 0;
    }
    (void)cudaGetLastError();  // a refused size is not an error yet
  }
  return (int)cudaErrorInvalidConfiguration;
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
      sequence_config(n, csize, slots, mode, stream, &attr);
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
