// The RGA sequence scan, for Hopper (sm_90a).
//
// Replaces the per-doc scan of automerge_tpu/fleet/sequence.py
// (_apply_seq_batch_impl :436, one lax.scan step _apply_one_doc :240 per op
// column, vmapped over docs). The state of one size class is
//   elem_id, nxt [R, S+3] int32 (node-indexed: HEAD 0, END 1, SCRATCH 2,
//   slots from 3), reg, val, counter [R, S+3, A] int32, killed [R, S+3, A]
//   uint8, n [R] int32, inexact [R] uint8;
// the batch is kind/ref/packed/value [R, P] int32, preds [R, P, D] int32
// and flag [R, P] uint8. seq_kernel.py states the rules of one op; this
// kernel applies them in place and adds the number of applied ops to
// *applied.
//
// Layout. One warp (one 32-thread block) per document row. A row's ops are
// ordered (an insert's referent may be an element inserted earlier in the
// batch) and rows are independent, so lane 0 walks the row's ops in order
// and does the scalar work of each: the skip walk, the splice and the
// [A]-lane register update, in place, touching only the cells the op
// names. The JAX step finds its referent with a one-hot compare over all
// S+3 nodes per op: O(P·S) per row, ~8·10^7 dependent loads at 10,000 ops
// on an 8,195-node row. Here the whole warp first builds a per-row index
// elemId -> first node holding it (open addressing, linear probing, load
// factor <= 1/2, in the scratch `table` the wrapper allocates: [R, T]
// uint64 words (uint32 key << 32 | node), 0 = empty), from the allocated
// slots [3, 3+n); lane 0 then finds each referent in O(1) expected and
// adds each inserted element. The warp also stages the op columns in
// shared memory 32 ops at a time with coalesced loads, so lane 0's chain
// of dependent loads holds only the state's cells.
//
// What bounds it on this card. Latency: each row is a serial chain of
// dependent loads (index probe, then the referent's nxt, then the next
// node's elem_id; a delete's register row) over a state far larger than
// the L2, and a fleet has only one thread per row doing that work. The
// bytes are small beside the state: the op columns once, the index build
// (the allocated slots' elem_ids read, T words written) and a few cells
// per op.
//
// Input contract (the engine's own states satisfy it; seq_kernel.check_rows
// tests it): every nxt entry lies in [0, S+3), and elem_id is 0 outside the
// allocated slots [3, 3+n). Under it the index finds the same node as the
// JAX one-hot's argmax: duplicates keep the lowest node (atomicMin while
// building; an insert lands above every allocated slot), and ref == 0 is
// never looked up (head for an insert, rejected for an update).
//
// Corners kept exactly as the JAX step computes them:
// - a miss never resolves to node 0; ref == 0 rejects SET/DEL/INC;
// - the skip walk compares elem_id > the insert's own id (signed) and
//   stops after capacity + 3 hops, so a cyclic chain terminates;
// - the cursor: an insert applies only while n < capacity, at slot 3 + n;
// - pred kills and the inc's "lose" kills act lane by lane, so duplicate
//   preds give the same result; preds <= 0 or past the lane width flag;
// - the inc's Lamport max is a signed max from 0 over the positive preds,
//   even a dead or out-of-range one, which then consumes the inc;
// - the counter lane's (sum << 2) | count-bits step wraps in int32 (done
//   in uint32); the +/-2^29 envelope test reads |sum| as jnp.abs does
//   (|INT32_MIN| stays negative);
// - an actor >= A is skipped for its lane write and flags the row.
// Offsets are int64: rows x nodes x A passes 2^31 at A = 256.
//
// Built by cuda_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers), bound with ctypes in seq_kernel.py.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;           // one warp per row
constexpr int kMaxPreds = 8;         // pred lanes the staging buffer holds
constexpr int32_t kPad = 0, kInsert = 1, kSet = 2, kDel = 3, kInc = 4;
constexpr int64_t kHead = 0, kSlot0 = 3;
constexpr int32_t kActorMask = 255;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint64_t probe_start(int32_t key, int shift) {
  return (static_cast<uint32_t>(key) * 2654435761u) >> shift;
}

__device__ __forceinline__ uint64_t entry(int32_t key, int64_t node) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(key)) << 32) |
         static_cast<uint64_t>(static_cast<uint32_t>(node));
}

__device__ __forceinline__ bool same_key(uint64_t word, int32_t key) {
  return static_cast<uint32_t>(word >> 32) == static_cast<uint32_t>(key);
}

// Concurrent insert while the warp builds the index: the lowest node wins.
__device__ void index_add_atomic(unsigned long long* table, uint64_t mask,
                                 int shift, int32_t key, int64_t node) {
  const unsigned long long word = entry(key, node);
  uint64_t s = probe_start(key, shift);
  while (true) {
    const unsigned long long old = atomicCAS(table + s, 0ull, word);
    if (old == 0ull) return;
    if (same_key(old, key)) {
      atomicMin(table + s, word);
      return;
    }
    s = (s + 1) & mask;
  }
}

// Lane 0's insert of a new element: it lies above every indexed node, so a
// key already present keeps its node.
__device__ void index_add(unsigned long long* table, uint64_t mask,
                          int shift, int32_t key, int64_t node) {
  uint64_t s = probe_start(key, shift);
  while (true) {
    const unsigned long long w = table[s];
    if (w == 0ull) {
      table[s] = entry(key, node);
      return;
    }
    if (same_key(w, key)) return;
    s = (s + 1) & mask;
  }
}

// The first node holding `key`, or -1.
__device__ int64_t index_find(const unsigned long long* table, uint64_t mask,
                              int shift, int32_t key) {
  uint64_t s = probe_start(key, shift);
  while (true) {
    const unsigned long long w = table[s];
    if (w == 0ull) return -1;
    if (same_key(w, key)) return static_cast<int64_t>(static_cast<uint32_t>(w));
    s = (s + 1) & mask;
  }
}

__global__ void __launch_bounds__(kLanes) seq_scan_kernel(
    int32_t* __restrict__ elem_id, int32_t* __restrict__ nxt,
    int32_t* __restrict__ reg, uint8_t* __restrict__ killed,
    int32_t* __restrict__ val, int32_t* __restrict__ counter,
    int32_t* __restrict__ n_alloc, uint8_t* __restrict__ inexact,
    const int32_t* __restrict__ kind, const int32_t* __restrict__ ref,
    const int32_t* __restrict__ packed, const int32_t* __restrict__ value,
    const int32_t* __restrict__ preds, const uint8_t* __restrict__ flag,
    int32_t* __restrict__ applied_out, unsigned long long* __restrict__ tables,
    int64_t nodes, int64_t a, int64_t p, int64_t d, int64_t t) {
  __shared__ int32_t s_kind[kLanes], s_ref[kLanes], s_packed[kLanes],
      s_value[kLanes], s_preds[kLanes * kMaxPreds];
  __shared__ uint8_t s_flag[kLanes];

  const int64_t doc = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t cap = nodes - 3;
  const int64_t op0 = doc * p;
  int32_t* E = elem_id + doc * nodes;
  int32_t* X = nxt + doc * nodes;
  const int64_t lane_base = doc * nodes * a;
  int32_t* R = reg + lane_base;
  uint8_t* K = killed + lane_base;
  int32_t* V = val + lane_base;
  int32_t* C = counter + lane_base;
  unsigned long long* table = tables + doc * t;
  const uint64_t mask = static_cast<uint64_t>(t) - 1;
  const int shift = 32 - __popcll(mask);

  // Does any op of the row look a referent up? Only then build the index.
  bool lookup = false;
  for (int64_t i = lane; i < p; i += kLanes) {
    const int32_t kd = kind[op0 + i];
    lookup |= kd >= kInsert && kd <= kInc && ref[op0 + i] != 0;
  }
  const bool indexed = __any_sync(kAll, lookup);
  int32_t nd = n_alloc[doc];
  if (indexed) {
    for (int64_t s = lane; s < t; s += kLanes) table[s] = 0ull;
    __syncthreads();
    const int64_t last = kSlot0 + min(static_cast<int64_t>(nd), cap);
    for (int64_t v = kSlot0 + lane; v < last; v += kLanes) {
      const int32_t key = E[v];
      if (key != 0) index_add_atomic(table, mask, shift, key, v);
    }
    __syncthreads();
  }

  bool bad = inexact[doc] != 0;
  int applied = 0;
  for (int64_t base = 0; base < p; base += kLanes) {
    const int64_t i = base + lane;
    if (i < p) {
      const int64_t o = op0 + i;
      s_kind[lane] = kind[o];
      s_ref[lane] = ref[o];
      s_packed[lane] = packed[o];
      s_value[lane] = value[o];
      s_flag[lane] = flag[o];
      for (int64_t j = 0; j < d; ++j)
        s_preds[lane * kMaxPreds + j] = preds[o * d + j];
    }
    __syncwarp();
    if (lane == 0) {
      const int count = static_cast<int>(min(static_cast<int64_t>(kLanes),
                                             p - base));
      for (int k = 0; k < count; ++k) {
        const int32_t kd = s_kind[k];
        bad |= s_flag[k] != 0;
        if (kd == kPad) continue;
        if (kd != kInsert && kd != kSet && kd != kDel && kd != kInc) {
          bad |= kd > kPad;          // an unknown kind is never applied
          continue;
        }
        const int32_t rf = s_ref[k], pk = s_packed[k], vl = s_value[k];
        const int32_t* pr = s_preds + k * kMaxPreds;
        const int64_t match = rf != 0 ? index_find(table, mask, shift, rf)
                                      : -1;
        if (kd == kInsert) {
          if (!(nd < cap && (rf == 0 || match >= 0))) {
            bad = true;              // over capacity or unknown referent
            continue;
          }
          int64_t cur = rf == 0 ? kHead : match;
          int64_t j = X[cur];
          for (int64_t h = 0; E[j] > pk && h < cap + 3; ++h) {
            cur = j;
            j = X[j];
          }
          const int64_t slot = kSlot0 + nd;
          X[slot] = static_cast<int32_t>(j);
          X[cur] = static_cast<int32_t>(slot);
          E[slot] = pk;
          if (indexed && pk != 0) index_add(table, mask, shift, pk, slot);
          ++nd;
          const int32_t own = pk & kActorMask;
          if (own < a) {
            const int64_t c = slot * a + own;
            R[c] = pk;
            K[c] = 0;
            V[c] = vl;
            C[c] = 0;
          } else {
            bad = true;              // actor beyond the lane width
          }
          ++applied;
          continue;
        }
        if (match < 0) {
          bad = true;                // unknown target, or ref == 0
          continue;
        }
        const int64_t row = match * a;
        // pred kills (sets and deletes), lane by lane
        for (int64_t q = 0; q < d; ++q) {
          const int32_t pj = pr[q];
          if (pj == 0) continue;
          const int32_t s = pj & kActorMask;
          if (pj < 0 || s >= a) {
            bad = true;
            continue;
          }
          if (kd != kInc && R[row + s] == pj) K[row + s] = 1;
        }
        if (kd == kInc) {
          int32_t max_pred = 0;
          bool any_live_hit = false;
          for (int64_t q = 0; q < d; ++q) {
            const int32_t pj = pr[q];
            if (pj <= 0) continue;
            max_pred = max(max_pred, pj);
            const int32_t s = pj & kActorMask;
            if (s < a && R[row + s] == pj && !K[row + s]) any_live_hit = true;
          }
          const int32_t sm = max_pred & kActorMask;
          const bool max_live = max_pred != 0 && sm < a &&
                                R[row + sm] == max_pred && !K[row + sm];
          if (max_live) {
            const int32_t old = C[row + sm];
            const int32_t sum = static_cast<int32_t>(
                static_cast<uint32_t>(old >> 2) + static_cast<uint32_t>(vl));
            if (sum != INT_MIN && abs(sum) >= (1 << 29)) bad = true;
            uint32_t stepped = (static_cast<uint32_t>(old) & ~3u) +
                               (static_cast<uint32_t>(vl) << 2);
            stepped |= (old & 3) == 0 ? 1u : 3u;
            C[row + sm] = static_cast<int32_t>(stepped);
          }
          for (int64_t q = 0; q < d; ++q) {
            const int32_t pj = pr[q];
            if (pj <= 0 || pj == max_pred) continue;
            const int32_t s = pj & kActorMask;
            if (s < a && R[row + s] == pj && !K[row + s]) K[row + s] = 1;
          }
          if (!(any_live_hit || max_live)) bad = true;
        } else if (kd == kSet) {
          const int32_t own = pk & kActorMask;
          if (own >= a) {
            bad = true;              // actor beyond the lane width
          } else {
            const int64_t c = row + own;
            const int32_t prev = R[c];
            bool own_pred = false;
            for (int64_t q = 0; q < d; ++q) own_pred |= pr[q] == prev;
            if (prev != 0 && !K[c] && !own_pred && prev != pk)
              bad = true;            // a self-conflict
            if ((C[c] & 3) != 0) bad = true;   // reclaims an inc'd lane
            R[c] = pk;
            K[c] = 0;
            V[c] = vl;
            C[c] = 0;
          }
        }
        ++applied;
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    n_alloc[doc] = nd;
    inexact[doc] = bad;
    if (applied) atomicAdd(applied_out, applied);
  }
}

}  // namespace

// Applies the batch to the rows in place (see above) and adds the number of
// applied ops to *applied (int32). `table` is scratch of rows x t uint64
// words, t a power of two >= 2 x (nodes - 3). Returns the CUDA error code of
// the launch (0 = cudaSuccess); an argument the kernel cannot take returns
// cudaErrorInvalidValue.
extern "C" int seq_scan_launch(
    void* elem_id, void* nxt, void* reg, void* killed, void* val,
    void* counter, void* n_alloc, void* inexact, const void* kind,
    const void* ref, const void* packed, const void* value, const void* preds,
    const void* flag, void* applied, void* table, int64_t rows, int64_t nodes,
    int64_t a, int64_t p, int64_t d, int64_t t, void* stream) {
  if (rows <= 0 || p <= 0) return 0;
  if (d < 0 || d > kMaxPreds || nodes < 4 || a < 1 || a > 256 ||
      t < 2 * (nodes - 3) || (t & (t - 1)) != 0 || t > (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  seq_scan_kernel<<<static_cast<unsigned>(rows), kLanes, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(elem_id), static_cast<int32_t*>(nxt),
      static_cast<int32_t*>(reg), static_cast<uint8_t*>(killed),
      static_cast<int32_t*>(val), static_cast<int32_t*>(counter),
      static_cast<int32_t*>(n_alloc), static_cast<uint8_t*>(inexact),
      static_cast<const int32_t*>(kind), static_cast<const int32_t*>(ref),
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(value),
      static_cast<const int32_t*>(preds), static_cast<const uint8_t*>(flag),
      static_cast<int32_t*>(applied),
      static_cast<unsigned long long*>(table), nodes, a, p, d, t);
  return static_cast<int>(cudaGetLastError());
}
