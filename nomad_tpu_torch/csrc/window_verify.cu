// Window verify of the group-commit applier (sm_90a, plain C ABI).
//
// Replaces nomad_tpu/parallel/mesh.py _window_verify_jit (K6): for every
// (plan, node) claim ("pair") of one verify window, the claim-scatter of
// its placement rows, the base fit against the resident fleet tensors,
// and the component-local overlay fold of the earlier plans' entries.
// Launched once per window by parallel/mesh.window_verify; on a mesh
// (parallel/mesh.window_verify_sharded) the same body runs on rows that
// each shard's K7d (shard_gather_kernel, below) gathered, through
// nomad_window_verify_gathered.
//
// Inputs: capacity/reserved/usage f32[N, D] row-major, resident on the
// card (only the D=6 rows the pairs claim are read, columns 0-3); one
// packed descriptor buffer of B-long arrays, B a power of two >= 8
// (every array padded to one shared bucket), laid out as int32
//   pair_ni | row_pair | seq_ni | seq_order | seq_comp | pair_order |
//   pair_comp | row_vec[B][4] | seq_vec[B][4] | pair_removed[B][4]
// with the three vector arrays holding float32 bits.  Output: one buffer
// of B records of kOutBytes, used f32[4] | caps f32[4] | fits u8 | 0 0 0.
//
//   used[p]  = (usage[ni] + reserved[ni]) + sum(row_vec[r], row_pair[r]==p)
//   caps[p]  = capacity[ni]
//   fits[p]  = all((used[p] + fold[p]) - pair_removed[p] <= caps[p])
//   fold[p]  = sum(seq_vec[s]) over the entries with seq_ni[s] == ni,
//              seq_order[s] < pair_order[p], seq_comp[s] == pair_comp[p]
//
// The host builds a window plan by plan, so the kernel takes three real
// counts and two orders (the engine passes its counts, the wrapper checks
// them): fold entries [0, entries) with seq_order nondecreasing, past
// them node -1; placement rows [0, rows) with row_pair nondecreasing,
// past them zero vectors; pairs [0, pairs) with pair_order
// nondecreasing, past them order <= 0 (no entry is earlier, so no fold).
// Nothing walks a padded tail.
//
// Bound on an H100: bytes at both windows, the gathered rows and the
// descriptors each read once: a few kilobytes at the fleet-scaling
// window (B = 64) and ~0.5 MB at a contended config-5b window (B =
// 8,192), well under a microsecond either way.  The parent of this
// kernel walked every (pair, fold entry), B x B compares; the function
// needs only B probes and one add per matching entry, and this kernel
// does that.  A block owns kPairs consecutive pairs (all of one plan, or
// of a few, in plan order):
//
//   1. it puts each of its pairs' (node, component) keys into an
//      open-addressed table in shared memory and places the pairs in
//      key order (pairs of a key in index order, so in pair order; where
//      every pair has a key of its own, each keeps its index); meanwhile
//      three warps search row_pair for the block's run of placement rows
//      and seq_order for the end of its fold entries (the first at or
//      above its largest pair order), 32 probes a round, and each pair's
//      thread loads its node's rows, first read at the end;
//   2. it streams those fold entries once, coalesced, four a thread
//      with their loads in flight together, on as few warps as one pass
//      needs (active_warps); each entry probes the table once, and a hit
//      adds its vector into ONE bin: that of the first of its key's
//      pairs with a later order (a binary search of the key's orders);
//      the run of placement rows adds into its pairs;
//   3. each key's bins are summed in pair order, so a pair's fold is
//      the sum of the bins up to its own: every entry of its key with
//      an earlier order, and no other (nothing to sum where every pair
//      has a key of its own).
//
// What is left is latency.  At a config-5b window the window's last
// block streams every earlier entry, each a probe, a search and an add
// in a chain on one SM.  At the fleet-scaling window (B = 64, under 64
// entries, every pair on a node of its own) the block's fixed phases
// are the time.  So a small window, one that one pass of a narrow block
// covers (one thread a pair, 4 warps; kUnroll entries and one row a
// thread), runs on narrow blocks: fewer warps to launch and to meet at
// each barrier, and nothing searched.  Their streaming warps load their
// entries and row before the table is built, mask entries at or past
// the cut and rows of other blocks' pairs, and skip the key ordering
// and the scan where the keys are distinct.  Any other window runs on
// wide blocks of 32 warps that search (chip_smoke.py reports the
// times; PERF.md keeps them).
//
// No atomics: shared-memory float atomics are compare-and-swap loops,
// and in a window where every pair sits on one node every entry of the
// stream lands in one bin.  Each warp adds into bins of its own: a warp
// whose lanes share one bin sums them by shuffles first, else lanes
// with the same bin (__match_any_sync) add in turns by their rank; the
// warps' bins are summed in warp order at the end.
//
// Exactness: every resource value is a small integer held in fp32, so
// every partial sum (a bin, a pair's rows, a prefix of bins) is exact
// below 2^24 and the grouping of the adds cannot change a bit; the
// results equal the plain version's masked product and index_add.
// Sums start at +0.0 (a -0.0 addend leaves +0.0, as in the plain
// version), and the fold only enters a compare.  Every add is a full
// fp32 add (-fmad=false, no fast math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairs = 128;                  // pairs per block
constexpr int kWide = 1024;                  // threads of a block, in general
constexpr int kNarrow = kPairs;              // of a small window's block
constexpr int kTargets = 2 * kPairs;         // a warp's bins: folds, rows
constexpr int kSlots = 4 * kPairs;           // table slots, a power of two
constexpr int kSlotBits = 9;                 // log2(kSlots)
constexpr int kUnroll = 4;                   // entries a thread loads at once
constexpr int kOutBytes = 36;                // one pair's output record
constexpr unsigned long long kEmpty = ~0ull;  // a node of -1: no pair's key
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a block of `threads`: every warp's bins,
// float4[warps][kTargets].
constexpr size_t smem_bytes(int threads) {
  return sizeof(float4) * (threads / 32) * kTargets;
}

// A small window: one pass of a narrow block covers it (see the header).
constexpr bool small_window(int rows, int entries) {
  return entries <= kUnroll * kNarrow && rows <= kNarrow;
}

__device__ __forceinline__ unsigned long long key_of(int ni, int comp) {
  return ((unsigned long long)(unsigned)ni << 32) | (unsigned)comp;
}

// A key's home slot: the node and component mixed (murmur3's finalizer),
// so the keys of neighbouring nodes do not crowd one run of the table.
__device__ __forceinline__ int slot_of(int ni, int comp) {
  unsigned x = (unsigned)ni * 0x9E3779B1u + (unsigned)comp * 0x85EBCA77u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (int)(x >> (32 - kSlotBits));
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

// The first r in [0, n) with a[r] >= v (n if none), a nondecreasing, by
// one warp: each round probes 32 evenly spaced points of the interval
// that holds the answer and keeps one of its 32 pieces.
__device__ int warp_lower_bound(const int* __restrict__ a, int n, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + (lane + 1) * step - 1;
    const bool below = q < hi && a[q] < v;
    const int c = __popc(__ballot_sync(kFull, below));
    const int next_hi = lo + (c + 1) * step - 1;
    lo += c * step;
    hi = next_hi < hi ? next_hi : hi;
  }
  return lo;
}

// Adds each lane's `v` into its warp's bin `t` (-1: none): where every
// lane has the same bin, as one sum over the warp; else the lanes of one
// bin in turns by rank.  The whole warp calls it.
__device__ __forceinline__ void warp_add(float4* bins, int t, float4 v) {
  if (__ballot_sync(kFull, t >= 0) == 0) return;
  int same = 0;
  __match_all_sync(kFull, t, &same);
  if (same) {
    for (int m = 16; m > 0; m >>= 1) {
      v.x = __fadd_rn(v.x, __shfl_xor_sync(kFull, v.x, m));
      v.y = __fadd_rn(v.y, __shfl_xor_sync(kFull, v.y, m));
      v.z = __fadd_rn(v.z, __shfl_xor_sync(kFull, v.z, m));
      v.w = __fadd_rn(v.w, __shfl_xor_sync(kFull, v.w, m));
    }
    if ((threadIdx.x & 31) == 0) {
      float4 a = bins[t];
      add4(a, v);
      bins[t] = a;
    }
    __syncwarp();
    return;
  }
  const unsigned peers = __match_any_sync(kFull, t);
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  const int rank = __popc(peers & lt);
  const int turns = __reduce_max_sync(kFull, t >= 0 ? __popc(peers) : 0);
  for (int k = 0; k < turns; ++k) {
    if (t >= 0 && rank == k) {
      float4 a = bins[t];
      add4(a, v);
      bins[t] = a;
    }
    __syncwarp();
  }
}

struct Entry {
  int order, ni, comp;
  float4 vec;
};

// The warps of `warps` a block streams with: enough that one pass of
// kUnroll entries and one row a thread covers `e_count` entries and
// `r_count` rows, at least one, at most all.
__device__ __forceinline__ int active_warps(int warps, int e_count,
                                            int r_count) {
  const int work = max((e_count + kUnroll - 1) / kUnroll, r_count);
  return min(warps, max(1, (work + 31) >> 5));
}

// This lane's kUnroll entries of the pass that starts at `base`: entry
// base + u * 32 * nw + lane for u < kUnroll, node -1 past e_end.
__device__ __forceinline__ void load_entries(
    Entry (&batch)[kUnroll], int base, int nw, int e_end,
    const int* __restrict__ seq_order, const int* __restrict__ seq_ni,
    const int* __restrict__ seq_comp, const float4* __restrict__ seq_vec) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int e = base + u * 32 * nw + lane;
    batch[u] = e < e_end ? Entry{seq_order[e], seq_ni[e], seq_comp[e],
                                 seq_vec[e]}
                         : Entry{0, -1, 0, make_float4(0.f, 0.f, 0.f, 0.f)};
  }
}

// kGathered: the pairs' rows come pre-gathered, `gathered` holding
// `shards` partials [shards][b][12] (usage, reserved, capacity columns
// 0-3 of pair p's node on the shard that owns it, zeros on the others),
// summed here; capacity/reserved/usage are not read (K7d, the sharded
// window verify).  pair_ni still names each pair's node: the fold
// compares it with the entries' nodes.
template <int kThreads, bool kGathered = false>
__global__ void __launch_bounds__(kThreads)
    window_verify_kernel(const float* __restrict__ capacity,
                         const float* __restrict__ reserved,
                         const float* __restrict__ usage, int d,
                         const int* __restrict__ desc, int b, int pairs,
                         int rows, int entries,
                         unsigned char* __restrict__ out,
                         const float* __restrict__ gathered, int shards) {
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

  constexpr int kWarps = kThreads / 32;
  constexpr bool kNarrowBlock = kThreads == kNarrow;
  extern __shared__ float4 s_warp_bins[];        // [kWarps][kTargets]
  __shared__ unsigned long long s_key[kSlots];   // the pairs' keys
  __shared__ int s_first[kSlots];  // a key's first position
  __shared__ int s_count[kSlots];  // and its pairs
  __shared__ int4 s_slot4[kPairs / 4];  // each pair's table slot
  int* s_slot = reinterpret_cast<int*>(s_slot4);
  __shared__ int s_order[kPairs];  // the pairs' orders, by position
  __shared__ float4 s_bin[kPairs];    // folds by position
  __shared__ float4 s_delta[kPairs];  // a wide block's placement rows
  __shared__ int s_ends[3];  // the run of rows [0], [1]; entries' end [2]
  __shared__ int s_keys;     // distinct keys in the table

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p0 = blockIdx.x * kPairs;
  const int p_end = min(p0 + kPairs, b);
  // Pairs of this block that may fold: [p0, p0 + live).
  const int live = max(0, min(kPairs, pairs - p0));
  // The block's largest pair order: no entry at or above it folds here.
  const int cut = live > 0 ? pair_order[p0 + live - 1] : 0;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // A narrow block runs only small windows (nomad_window_verify): one
  // pass covers every entry and row, so nothing is searched; entries at
  // or past the cut and rows of other blocks' pairs are masked instead,
  // and the streaming warps load their entries and row before the table
  // is built.
  int e_end = 0, r_begin = 0, r_end = 0, nw = 0;
  Entry batch[kUnroll];
  int rp = -1;       // this thread's row in a narrow block: its pair
  float4 rv = zero;  // and vector
  if constexpr (kNarrowBlock) {
    e_end = live > 0 ? entries : 0;
    r_end = rows;
    nw = active_warps(kWarps, e_end, rows);
    if (warp < nw) {
      load_entries(batch, warp * 32, nw, e_end, seq_order, seq_ni, seq_comp,
                   seq_vec);
      if (tid < rows) {
        rp = row_pair[tid];
        rv = row_vec[tid];
      }
    }
  }
  // The pair's own descriptors, in flight while the table is cleared.
  const int p = p0 + tid;
  const bool mine = tid < kPairs && p < p_end;
  const int ni = mine ? pair_ni[p] : 0;
  const int comp = tid < live ? pair_comp[p] : 0;
  const int order = tid < live ? pair_order[p] : 0;
  for (int i = tid; i < kSlots; i += kThreads) s_key[i] = kEmpty;
  if (tid == 0) s_keys = 0;
  __syncthreads();

  // 1. The table of keys; each pair's node rows, loaded now (a narrow
  // block first reads them at the end); in a wide block, the ends of the
  // rows and entries, searched by three warps.  A pair
  // that puts its key into the table notes itself as the key's only
  // pair, which stands where every key has one pair.
  float node_u[4], rs[4], cap[4];  // a wide block: usage + reserved
  float4 removed;
  if (mine) {
    const size_t row = (size_t)ni * d;
    for (int j = 0; j < 4; ++j) {
      float uj, rj, cj;
      if constexpr (kGathered) {
        uj = rj = cj = 0.0f;
        for (int s = 0; s < shards; ++s) {
          const float* g = gathered + ((size_t)s * b + p) * 12;
          uj = __fadd_rn(uj, g[j]);
          rj = __fadd_rn(rj, g[4 + j]);
          cj = __fadd_rn(cj, g[8 + j]);
        }
      } else {
        uj = usage[row + j];
        rj = reserved[row + j];
        cj = capacity[row + j];
      }
      if constexpr (kNarrowBlock) {
        node_u[j] = uj;
        rs[j] = rj;
      } else {
        node_u[j] = __fadd_rn(uj, rj);
      }
      cap[j] = cj;
    }
    removed = pair_removed[p];
  }
  if (tid < kPairs) s_slot[tid] = kSlots;  // past the live pairs: no slot
  if (tid < live) {
    const unsigned long long key = key_of(ni, comp);
    int h = slot_of(ni, comp);
    for (;;) {
      const unsigned long long prev = atomicCAS(&s_key[h], kEmpty, key);
      if (prev == kEmpty) {
        atomicAdd(&s_keys, 1);
        s_first[h] = tid;
        s_count[h] = 1;
        break;
      }
      if (prev == key) break;
      h = (h + 1) & (kSlots - 1);
    }
    s_slot[tid] = h;
    s_order[tid] = order;
  } else if constexpr (!kNarrowBlock) {
    if (warp >= kWarps - 3) {
      const int which = warp - (kWarps - 3);
      const int r =
          which == 2
              ? warp_lower_bound(seq_order, live > 0 ? entries : 0, cut)
              : warp_lower_bound(row_pair, rows, which == 0 ? p0 : p_end);
      if (lane == 0) s_ends[which] = r;
    }
  }
  __syncthreads();
  // Every pair its own key (the fleet-scaling window): the positions are
  // the pairs' own, the table is complete, and no key's bins need a
  // scan.
  const bool distinct = s_keys == live;
  if constexpr (!kNarrowBlock) {
    r_begin = s_ends[0];
    r_end = s_ends[1];
    e_end = s_ends[2];
    nw = active_warps(kWarps, e_end, r_end - r_begin);
  }
  int pos = tid;  // this pair's position in key order
  if (!distinct) {
    if (tid < live) {
      // Position in (slot, index) order; the first pair of a slot notes
      // where its key's pairs start and how many there are.
      const int s = s_slot[tid];
      int before = 0, total = 0;
      pos = 0;
      for (int j4 = 0; j4 < (live + 3) / 4; ++j4) {
        const int4 w = s_slot4[j4];
        const int sj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * j4 + i;
          pos += sj[i] < s || (sj[i] == s && j < tid);
          before += sj[i] == s && j < tid;
          total += sj[i] == s;
        }
      }
      s_order[pos] = order;  // over what each pair noted of itself
      if (before == 0) {
        s_first[s] = pos;
        s_count[s] = total;
      }
    }
    __syncthreads();
  }

  // 2. The fold entries below the cut, then the rows, each into this
  // warp's bins (a warp steps through them together, kUnroll entries a
  // thread with their loads in flight at once).  Only the first nw warps
  // stream.
  if (warp < nw) {
    float4* bins = s_warp_bins + (size_t)warp * kTargets;
    for (int i = lane; i < kTargets; i += 32) bins[i] = zero;
    __syncwarp();
    const int stride = kUnroll * 32 * nw;
    if constexpr (!kNarrowBlock)
      load_entries(batch, warp * 32, nw, e_end, seq_order, seq_ni, seq_comp,
                   seq_vec);
    for (int base = warp * 32; base < e_end;) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const Entry& cur = batch[u];
        int t = -1;
        if (cur.ni >= 0 && cur.order < cut) {
          const unsigned long long key = key_of(cur.ni, cur.comp);
          int h = slot_of(cur.ni, cur.comp);
          unsigned long long k = s_key[h];
          while (k != key && k != kEmpty) {
            h = (h + 1) & (kSlots - 1);
            k = s_key[h];
          }
          if (k == key) {
            int lo = s_first[h];
            const int end = lo + s_count[h];
            int hi = end;
            while (lo < hi) {  // the first of the key's pairs after cur.order
              const int mid = (lo + hi) >> 1;
              if (s_order[mid] > cur.order) hi = mid; else lo = mid + 1;
            }
            if (lo < end) t = lo;
          }
        }
        warp_add(bins, t, cur.vec);
      }
      base += stride;
      if (base < e_end)
        load_entries(batch, base, nw, e_end, seq_order, seq_ni, seq_comp,
                     seq_vec);
    }
    if constexpr (kNarrowBlock) {
      const bool in = rp >= p0 && rp < p_end;
      warp_add(bins, in ? kPairs + rp - p0 : -1, rv);
    } else {
      for (int r = r_begin + warp * 32 + lane; r - lane < r_end;
           r += 32 * nw) {
        const bool in = r < r_end;
        warp_add(bins, in ? kPairs + row_pair[r] - p0 : -1,
                 in ? row_vec[r] : zero);
      }
    }
  }
  __syncthreads();

  // 3. Each key's bins summed in pair order: bin j becomes its pair's
  // fold (after the streaming warps' bins are summed into s_bin).
  auto scan_keys = [&]() {
    if (tid < live && s_first[s_slot[tid]] == pos) {
      const int end = pos + s_count[s_slot[tid]];
      float4 acc = s_bin[pos];
      for (int j = pos + 1; j < end; ++j) {
        add4(acc, s_bin[j]);
        s_bin[j] = acc;
      }
    }
  };
  // The streaming warps' bins, summed in warp order.
  float4 fold = zero, delta = zero;
  if constexpr (kNarrowBlock) {
    // Thread tid: the bin at position tid and pair tid's rows.
    fold = s_warp_bins[tid];
    delta = s_warp_bins[kPairs + tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (w < nw) {
        add4(fold, s_warp_bins[w * kTargets + tid]);
        add4(delta, s_warp_bins[w * kTargets + kPairs + tid]);
      }
    }
    if (!distinct) {
      s_bin[tid] = fold;
      __syncthreads();
      scan_keys();
      __syncthreads();
      fold = s_bin[pos];
    }
  } else {
    if (tid < kTargets) {
      float4 acc = s_warp_bins[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        if (w < nw) add4(acc, s_warp_bins[w * kTargets + tid]);
      if (tid < kPairs) s_bin[tid] = acc; else s_delta[tid - kPairs] = acc;
    }
    __syncthreads();
    if (!distinct) {
      scan_keys();
      __syncthreads();
    }
    if (tid < kPairs) {
      fold = s_bin[pos];
      delta = s_delta[tid];
    }
  }

  if (tid >= kPairs || p >= p_end) return;
  if (tid >= live) fold = zero;
  const float dl[4] = {delta.x, delta.y, delta.z, delta.w};
  const float f[4] = {fold.x, fold.y, fold.z, fold.w};
  const float r[4] = {removed.x, removed.y, removed.z, removed.w};
  float* rec = reinterpret_cast<float*>(out + (size_t)p * kOutBytes);
  bool fits = true;
  for (int j = 0; j < 4; ++j) {
    const float node =
        kNarrowBlock ? __fadd_rn(node_u[j], rs[j]) : node_u[j];
    const float used = __fadd_rn(node, dl[j]);
    rec[j] = used;
    rec[4 + j] = cap[j];
    fits = fits && (__fsub_rn(__fadd_rn(used, f[j]), r[j]) <= cap[j]);
  }
  reinterpret_cast<uint32_t*>(rec)[8] = fits ? 1u : 0u;  // fits, 0, 0, 0
}

}  // namespace

extern "C" {

const char* nomad_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Raises the shared memory K6's wide blocks may use on the current
// device; once per device, before its first launch there.
int nomad_window_verify_setup() {
  return (int)cudaFuncSetAttribute(window_verify_kernel<kWide>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(kWide));
}

// A window's bucket (a power of two >= 8) and real counts, as K6 takes
// them.
static bool window_args_ok(int b, int pairs, int rows, int entries) {
  return b >= 8 && (b & (b - 1)) == 0 && pairs >= 0 && pairs <= b &&
         rows >= 0 && rows <= b && entries >= 0 && entries <= b;
}

// K6 over a window of bucket b whose first `pairs` pairs may fold, with
// `rows` placement rows and `entries` fold entries (the real counts, in
// window order; see the header); `out` holds b records of 36 bytes.  A
// window one pass of a narrow block covers runs on narrow blocks (one
// thread a pair), any other on wide ones.
int nomad_window_verify(const float* capacity, const float* reserved,
                        const float* usage, int d, const int* desc, int b,
                        int pairs, int rows, int entries, unsigned char* out,
                        void* stream) {
  if (!window_args_ok(b, pairs, rows, entries))
    return (int)cudaErrorInvalidValue;
  const int blocks = (b + kPairs - 1) / kPairs;
  if (small_window(rows, entries))
    window_verify_kernel<kNarrow>
        <<<blocks, kNarrow, smem_bytes(kNarrow), (cudaStream_t)stream>>>(
            capacity, reserved, usage, d, desc, b, pairs, rows, entries, out,
            nullptr, 0);
  else
    window_verify_kernel<kWide>
        <<<blocks, kWide, smem_bytes(kWide), (cudaStream_t)stream>>>(
            capacity, reserved, usage, d, desc, b, pairs, rows, entries, out,
            nullptr, 0);
  return (int)cudaGetLastError();
}

// Raises the shared memory of the gathered K6's wide blocks on the
// current device; once per device, before its first launch there.
int nomad_window_verify_gathered_setup() {
  return (int)cudaFuncSetAttribute(window_verify_kernel<kWide, true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(kWide));
}

// K6 on rows gathered by K7d: `gathered` [shards][b][12] on this device
// (see window_verify_kernel); otherwise as nomad_window_verify.
int nomad_window_verify_gathered(const float* gathered, int shards,
                                 const int* desc, int b, int pairs, int rows,
                                 int entries, unsigned char* out,
                                 void* stream) {
  if (!window_args_ok(b, pairs, rows, entries) || shards < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (b + kPairs - 1) / kPairs;
  if (small_window(rows, entries))
    window_verify_kernel<kNarrow, true>
        <<<blocks, kNarrow, smem_bytes(kNarrow), (cudaStream_t)stream>>>(
            nullptr, nullptr, nullptr, 0, desc, b, pairs, rows, entries, out,
            gathered, shards);
  else
    window_verify_kernel<kWide, true>
        <<<blocks, kWide, smem_bytes(kWide), (cudaStream_t)stream>>>(
            nullptr, nullptr, nullptr, 0, desc, b, pairs, rows, entries, out,
            gathered, shards);
  return (int)cudaGetLastError();
}

// K7d: one shard's part of a sharded window's rows.  The shard holds
// fleet rows [row_lo, row_lo + rows) of capacity/reserved/usage f32
// [rows][d]; for each of the b pairs (pair_ni, global node ids) it
// writes to out [b][12] the usage, reserved and capacity columns 0-3 of
// the pair's node where the shard owns it, and zeros where it does not.
// Each node has one owner, so the partials of all shards sum to the
// rows exactly (the gathered K6 sums them).  Bound: 48 bytes a pair
// written, the owned rows read: bytes, far under a microsecond at
// b = 64; the launch is the cost.
__global__ void shard_gather_kernel(const float* __restrict__ capacity,
                                    const float* __restrict__ reserved,
                                    const float* __restrict__ usage, int d,
                                    int row_lo, int rows,
                                    const int* __restrict__ pair_ni, int b,
                                    float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= b) return;
  const int local = pair_ni[p] - row_lo;
  const bool own = local >= 0 && local < rows;
  const size_t row = own ? (size_t)local * d : 0;
  float* o = out + (size_t)p * 12;
  for (int j = 0; j < 4; ++j) {
    o[j] = own ? usage[row + j] : 0.0f;
    o[4 + j] = own ? reserved[row + j] : 0.0f;
    o[8 + j] = own ? capacity[row + j] : 0.0f;
  }
}

int nomad_shard_gather(const float* capacity, const float* reserved,
                       const float* usage, int d, int row_lo, int rows,
                       const int* pair_ni, int b, float* out, void* stream) {
  if (d < 4 || rows < 1 || b < 1) return (int)cudaErrorInvalidValue;
  shard_gather_kernel<<<(b + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      capacity, reserved, usage, d, row_lo, rows, pair_ni, b, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
