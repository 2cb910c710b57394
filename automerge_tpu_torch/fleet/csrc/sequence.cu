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
// stats[0] (and the number of rows that took the serial route to stats[1]).
//
// What bounds it. A row's ops are ordered, rows are independent, and the
// list splice is a chain of dependent loads: an insert reads its referent's
// nxt, then the next node's elem_id, hop after hop. Nothing else in a row is
// serial, but everything the row reads from device memory waits ~1-3 us
// under load (the rows' state, ~400 MB at the text cell, dwarfs the 50 MB
// L2). The previous design ran the whole row on lane 0 of one warp, each
// link a trip to HBM: ~1.5 us per op. This one splits a row's work into
// what is ordered and what is not, keeps the ordered part and the lookups
// on chip, and keeps device-memory loads off the serial chain.
//
// One CTA of 256 threads per row, in three phases, over the row's elem_id
// (int32) held in shared memory and a second region that holds the row's
// lookup table during phase A and its nxt (uint16) after it ('resident'
// route: 8,195 nodes take 55 KB, so 4 rows share an SM).
//
// Phase A (all 8 warps): resolve every op's node in parallel. While every
// insert of the row applies, insert k (in column order) lands at slot
// 3 + n0 + k, an exclusive prefix count, and the referent of an op at
// column i is the lowest node holding its ref among the slots allocated
// before the batch [3, 3+n0), else the slot of the earliest insert at a
// column before i with that packed id. Duplicates keep the lowest node, as
// the JAX argmax does; a ref naming a later insert misses; ref == 0 is the
// head for an insert and a miss otherwise. The new slots' ids are written
// into elem_id for the phase (and cleared after it), so one open-addressing
// table of nodes (uint16, 0 = empty, load <= 0.8, keys read back from
// elem_id; atomicCAS keeps the lowest node) covers both sides. The phase
// also counts the applied ops and raises the flags that need no state (the
// host flag, unknown kinds, misses). The shortcut is exact only when every
// insert applies: n0 + inserts <= capacity and every insert's referent
// resolves (by induction over the columns). A row where that fails takes
// the serial route.
//
// Phase B (warp 0, lane 0): the splice chain, in column order. Per insert:
// nxt[cur], then elem_id[j] > packed, hop, splice, and the new slot's id
// stored at that moment (a nxt may point at a slot not yet allocated, where
// the walk reads 0). A lone thread pays every dependent instruction's
// latency, so the chain carries nothing else: the warp compacts each block
// of 128 columns' inserts (id, referent) in shared memory first, and lane 0
// reads the next insert's links (nxt of its referent, elem_id there) while
// it splices the current one, then corrects them from the three cells the
// splice wrote. Each link is a shared-memory load of ~30 cycles; the next
// block's columns load from device memory behind the walk. nxt is written
// back whole, elem_id from slot 3 + n0 on.
//
// Phase C (warp 1, beside phase B): the register updates of every applied
// op ([node, A] lanes of reg, killed, val, counter), which read nothing the
// splice writes. Ops on distinct nodes commute, ops on one node apply in
// column order: 32 columns at a time, __match_any_sync groups the lanes by
// node and each group's first lane applies the group's ops in order; the
// next 32 columns load while it does.
//
// Serial route (lane 0, per row, inside the same launch): a row over
// capacity or with an insert whose referent does not resolve (every later
// slot shifts) runs the ops one by one: the table rebuilt from the
// allocated slots and extended as inserts land, the walk over nxt in device
// memory, the splice and the register update of each op. Exact, never the
// plain version.
//
// 'global' route: a class whose row does not fit a CTA's shared memory
// (above ~35,000 nodes) runs the same phases over device memory (the table
// in scratch, uint32 nodes). seq_kernel._launch_plan picks the route.
//
// Input contract (the engine's own states satisfy it; seq_kernel.check_rows
// tests it): every nxt entry lies in [0, S+3), and elem_id is 0 outside the
// allocated slots [3, 3+n).
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
#include <type_traits>

namespace {

constexpr int kThreads = 256;        // one CTA per row; all warps in phase A
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPreds = 8;         // pred lanes the staging holds
constexpr int kIlp = 4;              // column loads a lane keeps in flight
constexpr int kAhead = 128;          // columns phase B loads ahead
constexpr int32_t kPad = 0, kInsert = 1, kSet = 2, kDel = 3, kInc = 4;
constexpr int64_t kHead = 0, kSlot0 = 3;
constexpr int32_t kActorMask = 255;
constexpr unsigned kAll = 0xffffffffu;
// Phase B stages kAhead (id, referent) pairs and two sentinels, phase C 32
// ops (kind, id, value, preds): seq_kernel.STAGE_BYTES.
constexpr int kStageInts = 2 * (kAhead + 2) + 32 * (3 + kMaxPreds);
constexpr int64_t kStageBytes = kStageInts * 4;
constexpr int64_t kMaxResidentNodes = 65536;   // nxt and table as uint16

__host__ __device__ constexpr int64_t round16(int64_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Table entries for a row of `cap` slots (it holds at most cap nodes):
// load <= 0.8 (seq_kernel.table_slots).
__host__ __device__ constexpr int64_t table_entries(int64_t cap) {
  return (cap * 5 / 4 + 7) / 8 * 8 + 8;
}

// Shared bytes of a resident row: elem_id, then the table or nxt.
__host__ __device__ constexpr int64_t resident_bytes(int64_t nodes) {
  return round16(nodes * 4) +
         round16(2 * (nodes > table_entries(nodes - 3)
                          ? nodes
                          : table_entries(nodes - 3)));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int warp_sum(int x) {
  return __reduce_add_sync(kAll, x);
}

// ---- the row's lookup table: an open-addressing set of nodes --------------
// An entry is a node (0 = empty: keys live at slots >= 3); its key is
// elem_id[node]. Slot is uint16 in shared memory (resident) or uint32 in
// device-memory scratch (global, read through __ldcg: the L2, where the
// atomics land).

template <typename Slot>
struct Table {
  Slot* w;
  const int32_t* E;
  uint32_t size;
};

template <typename Slot>
__device__ __forceinline__ Slot table_read(const Table<Slot>& t, uint32_t s) {
  if constexpr (sizeof(Slot) == 2)
    return t.w[s];
  else
    return __ldcg(t.w + s);
}

template <typename Slot>
__device__ __forceinline__ uint32_t probe_start(const Table<Slot>& t,
                                                int32_t key) {
  const uint32_t h = static_cast<uint32_t>(key) * 2654435761u;
  return static_cast<uint32_t>((static_cast<uint64_t>(h) * t.size) >> 32);
}

template <typename Slot>
__device__ __forceinline__ uint32_t probe_next(const Table<Slot>& t,
                                               uint32_t s) {
  return s + 1 == t.size ? 0 : s + 1;
}

// Adds `node` (whose key elem_id[node] is nonzero) concurrently: of the
// nodes holding one key, the lowest stays.
template <typename Slot>
__device__ void table_define(const Table<Slot>& t, uint32_t node) {
  const int32_t key = t.E[node];
  const Slot want = static_cast<Slot>(node);
  uint32_t s = probe_start(t, key);
  while (true) {
    Slot cur = table_read(t, s);
    if (cur == 0) {
      cur = atomicCAS(t.w + s, Slot(0), want);
      if (cur == 0) return;
    }
    if (t.E[cur] == key) {
      while (want < cur) {
        const Slot old = atomicCAS(t.w + s, cur, want);
        if (old == cur) return;
        cur = old;
      }
      return;
    }
    s = probe_next(t, s);
  }
}

// The serial route's definition of a new slot, above every node defined
// before it: a key already held keeps its node.
template <typename Slot>
__device__ void table_define_serial(const Table<Slot>& t, uint32_t node) {
  const int32_t key = t.E[node];
  uint32_t s = probe_start(t, key);
  while (true) {
    const Slot cur = table_read(t, s);
    if (cur == 0) {
      t.w[s] = static_cast<Slot>(node);
      return;
    }
    if (t.E[cur] == key) return;
    s = probe_next(t, s);
  }
}

// The lowest node holding `key` (nonzero), or -1.
template <typename Slot>
__device__ int64_t table_find(const Table<Slot>& t, int32_t key) {
  uint32_t s = probe_start(t, key);
  while (true) {
    const Slot cur = table_read(t, s);
    if (cur == 0) return -1;
    if (t.E[cur] == key) return cur;
    s = probe_next(t, s);
  }
}

// ---- one op's register update on node v (phase C and the serial route) ----

struct Lanes {
  int32_t* R;
  uint8_t* K;
  int32_t* V;
  int32_t* C;
  int64_t a;
};

// Applies an applied op's lane writes to node v; returns true where the op
// makes the row inexact.
__device__ bool apply_registers(const Lanes& L, int32_t kd, int32_t pk,
                                int32_t vl, const int32_t* pr, int64_t d,
                                int64_t v) {
  const int64_t a = L.a;
  const int64_t row = v * a;
  int32_t* R = L.R;
  uint8_t* K = L.K;
  int32_t* V = L.V;
  int32_t* C = L.C;
  bool bad = false;
  if (kd == kInsert) {
    const int32_t own = pk & kActorMask;
    if (own < a) {
      const int64_t c = row + own;
      R[c] = pk;
      K[c] = 0;
      V[c] = vl;
      C[c] = 0;
    } else {
      bad = true;                    // actor beyond the lane width
    }
    return bad;
  }
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
      bad = true;                    // actor beyond the lane width
    } else {
      const int64_t c = row + own;
      const int32_t prev = R[c];
      bool own_pred = false;
      for (int64_t q = 0; q < d; ++q) own_pred |= pr[q] == prev;
      if (prev != 0 && !K[c] && !own_pred && prev != pk)
        bad = true;                  // a self-conflict
      if ((C[c] & 3) != 0) bad = true;   // reclaims an inc'd lane
      R[c] = pk;
      K[c] = 0;
      V[c] = vl;
      C[c] = 0;
    }
  }
  return bad;
}


// The serial route's skip walk and splice of one insert after `cur` into
// `slot` (elem_id is 0 past the allocated slots there).
template <typename XT>
__device__ void splice(int32_t* E, XT* X, int64_t cap, int64_t cur,
                       int32_t pk, int64_t slot) {
  int64_t j = X[cur];
  for (int64_t h = 0; E[j] > pk && h < cap + 3; ++h) {
    cur = j;
    j = X[j];
  }
  X[slot] = static_cast<XT>(j);
  X[cur] = static_cast<XT>(slot);
  E[slot] = pk;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 4) seq_scan_kernel(
    int32_t* __restrict__ elem_id, int32_t* __restrict__ nxt,
    int32_t* __restrict__ reg, uint8_t* __restrict__ killed,
    int32_t* __restrict__ val, int32_t* __restrict__ counter,
    int32_t* __restrict__ n_alloc, uint8_t* __restrict__ inexact,
    const int32_t* __restrict__ kind, const int32_t* __restrict__ ref,
    const int32_t* __restrict__ packed, const int32_t* __restrict__ value,
    const int32_t* __restrict__ preds, const uint8_t* __restrict__ flag,
    int32_t* __restrict__ stats, int32_t* __restrict__ aux,
    uint32_t* __restrict__ tables, int64_t nodes, int64_t a, int64_t p,
    int64_t d, int64_t t_size) {
  using XT = std::conditional_t<kResident, uint16_t, int32_t>;
  using Slot = std::conditional_t<kResident, uint16_t, uint32_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_live, s_applied, s_bad, s_unresolved, s_nd;

  const int64_t doc = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int64_t cap = nodes - 3;
  const int64_t op0 = doc * p;
  int32_t* gE = elem_id + doc * nodes;
  int32_t* gX = nxt + doc * nodes;
  int32_t* A = aux + op0;
  const int64_t lane_base = doc * nodes * a;
  const Lanes L{reg + lane_base, killed + lane_base, val + lane_base,
                counter + lane_base, a};
  // Phase A gives each warp a segment of the columns, 32 x kIlp at a time.
  const int64_t seg = ((p + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int64_t c0 = min(p, warp * seg), c1 = min(p, c0 + seg);
  if (tid == 0) s_live = s_applied = s_bad = s_unresolved = 0;
  __syncthreads();

  // ---- phase A, pass 1: counts, the inserts before each column within its
  // warp's segment (into aux), the host flags and unknown kinds
  {
    int live = 0, local = 0;
    bool bad = false;
    for (int64_t base = c0; base < c1; base += 32 * kIlp) {
      int32_t kd[kIlp];
      bool fl[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int64_t i = base + u * 32 + lane;
        kd[u] = i < c1 ? kind[op0 + i] : kPad;
        fl[u] = i < c1 && flag[op0 + i] != 0;
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int64_t i = base + u * 32 + lane;
        bad |= fl[u] || kd[u] > kInc;   // an unknown kind is never applied
        live += kd[u] >= kInsert && kd[u] <= kInc;
        const unsigned m = __ballot_sync(kAll, kd[u] == kInsert);
        if (i < c1) A[i] = local + __popc(m & lt);
        local += __popc(m);
      }
    }
    live = warp_sum(live);
    const bool any_bad = __any_sync(kAll, bad);
    if (lane == 0) {
      s_warp[warp] = local;
      atomicAdd(&s_live, live);
      if (any_bad) s_bad = 1;
    }
  }
  __syncthreads();
  const bool was_inexact = inexact[doc] != 0;
  if (s_live == 0) {                    // no op to apply: flags only
    if (tid == 0 && s_bad) inexact[doc] = 1;
    return;
  }
  int64_t ins_total = 0, ins_off = 0;   // all inserts; those before c0
  for (int w = 0; w < kWarps; ++w) {
    ins_off += w < warp ? s_warp[w] : 0;
    ins_total += s_warp[w];
  }
  const int64_t n0 = min(static_cast<int64_t>(n_alloc[doc]), cap);
  const int64_t base_slot = kSlot0 + n0;
  const bool fits = n0 + ins_total <= cap;
  // the slots the table covers: allocated, then (fits) the batch's inserts
  const int64_t end_slot = fits ? base_slot + ins_total : base_slot;

  // the row's elem_id on chip (resident); the table
  int32_t* E;
  Slot* tw;
  unsigned char* stage_at;
  if constexpr (kResident) {
    E = reinterpret_cast<int32_t*>(smem);
    tw = reinterpret_cast<Slot*>(smem + round16(nodes * 4));
    stage_at = smem + resident_bytes(nodes);
    for (int64_t v = tid; v < nodes; v += kThreads) cp_async4(E + v, gE + v);
  } else {
    E = gE;
    tw = tables + doc * t_size;
    stage_at = smem;
  }
  int32_t* stage = reinterpret_cast<int32_t*>(stage_at);
  const Table<Slot> tab{tw, E, static_cast<uint32_t>(t_size)};
  for (int64_t s = tid; s < t_size; s += kThreads) tw[s] = 0;
  if constexpr (kResident) cp_async_wait_all();
  __syncthreads();

  // ---- phase A, passes 2-4: the new slots' ids, the table, every op's node
  if (fits) {
    for (int64_t base = c0; base < c1; base += 32 * kIlp) {
      int32_t kd[kIlp], pk[kIlp], at[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int64_t i = base + u * 32 + lane;
        kd[u] = kPad;
        if (i < c1) {
          kd[u] = kind[op0 + i];
          pk[u] = packed[op0 + i];
          at[u] = A[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
        if (kd[u] == kInsert) E[base_slot + ins_off + at[u]] = pk[u];
    }
    __syncthreads();
  }
  for (int64_t v = kSlot0 + tid; v < end_slot; v += kThreads)
    if (E[v] != 0) table_define(tab, static_cast<uint32_t>(v));
  __syncthreads();
  if (fits) {
    int applied = 0;
    bool bad = false, unresolved = false;
    for (int64_t base = c0; base < c1; base += 32 * kIlp) {
      int32_t kd[kIlp], rf[kIlp], at[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int64_t i = base + u * 32 + lane;
        kd[u] = kPad;
        if (i < c1) {
          kd[u] = kind[op0 + i];
          rf[u] = ref[op0 + i];
          at[u] = A[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int64_t i = base + u * 32 + lane;
        if (!(kd[u] >= kInsert && kd[u] <= kInc)) continue;
        int64_t node;
        if (rf[u] == 0) {
          node = kd[u] == kInsert ? kHead : -1;
        } else {
          node = table_find(tab, rf[u]);
          // an insert's slot counts only if it comes before column i
          if (node >= base_slot && node - base_slot >= ins_off + at[u])
            node = -1;
        }
        A[i] = static_cast<int32_t>(node);
        applied += node >= 0;
        bad |= node < 0;
        unresolved |= node < 0 && kd[u] == kInsert;
      }
    }
    applied = warp_sum(applied);
    const bool any_bad = __any_sync(kAll, bad);
    const bool any_unres = __any_sync(kAll, unresolved);
    if (lane == 0) {
      atomicAdd(&s_applied, applied);
      if (any_bad) s_bad = 1;
      if (any_unres) s_unresolved = 1;
    }
    __syncthreads();
  }
  const bool serial = !fits || s_unresolved;
  if (serial && fits) {
    // back to the allocated slots alone: the serial route adds each insert
    // to elem_id and the table as it lands
    for (int64_t v = base_slot + tid; v < end_slot; v += kThreads) E[v] = 0;
    for (int64_t s = tid; s < t_size; s += kThreads) tw[s] = 0;
    __syncthreads();
    for (int64_t v = kSlot0 + tid; v < base_slot; v += kThreads)
      if (E[v] != 0) table_define(tab, static_cast<uint32_t>(v));
  }
  // phase B writes each new slot's id as it lands: the slots read 0 before
  if (!serial)
    for (int64_t v = base_slot + tid; v < end_slot; v += kThreads) E[v] = 0;
  // nxt on chip in the table's place (resident, parallel route)
  XT* X = reinterpret_cast<XT*>(gX);
  if constexpr (kResident) {
    X = reinterpret_cast<XT*>(tw);
    if (!serial) {
      for (int64_t v0 = tid; v0 < nodes; v0 += kThreads * 8) {
        int32_t x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int64_t v = v0 + u * kThreads;
          x[u] = v < nodes ? gX[v] : 0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int64_t v = v0 + u * kThreads;
          if (v < nodes) X[v] = static_cast<XT>(x[u]);
        }
      }
    }
  }
  __syncthreads();

  if (serial) {
    // ---- the serial route: every op in column order on lane 0
    if (tid == 0) {
      int64_t nd = n0;
      bool bad = false;
      int applied = 0;
      for (int64_t i = 0; i < p; ++i) {
        const int64_t o = op0 + i;
        const int32_t kd = kind[o];
        bad |= flag[o] != 0;
        if (kd == kPad) continue;
        if (kd != kInsert && kd != kSet && kd != kDel && kd != kInc) {
          bad |= kd > kPad;
          continue;
        }
        const int32_t rf = ref[o], pk = packed[o], vl = value[o];
        const int32_t* pr = preds + o * d;
        const int64_t match = rf != 0 ? table_find(tab, rf) : -1;
        if (kd == kInsert) {
          if (!(nd < cap && (rf == 0 || match >= 0))) {
            bad = true;              // over capacity or unknown referent
            continue;
          }
          const int64_t slot = kSlot0 + nd;
          splice(E, gX, cap, rf == 0 ? kHead : match, pk, slot);
          if (pk != 0) table_define_serial(tab, static_cast<uint32_t>(slot));
          ++nd;
          bad |= apply_registers(L, kd, pk, vl, pr, d, slot);
          ++applied;
          continue;
        }
        if (match < 0) {
          bad = true;                // unknown target, or ref == 0
          continue;
        }
        bad |= apply_registers(L, kd, pk, vl, pr, d, match);
        ++applied;
      }
      s_nd = static_cast<int>(nd);
      s_applied = applied;
      s_bad = bad;
    }
  } else if (warp == 0) {
    // ---- phase B: the splice chain
    int2* s_ins = reinterpret_cast<int2*>(stage);     // (id, referent)
    const int32_t hops = static_cast<int32_t>(cap + 3);
    int32_t slot = static_cast<int32_t>(base_slot);   // the next insert's
    int32_t nkd[kAhead / 32], nk[kAhead / 32], nr[kAhead / 32];
    auto load = [&](int64_t base) {
#pragma unroll
      for (int u = 0; u < kAhead / 32; ++u) {
        const int64_t i = base + u * 32 + lane;
        nkd[u] = kPad;
        if (i < p) {
          nkd[u] = kind[op0 + i];
          nk[u] = packed[op0 + i];
          nr[u] = A[i];
        }
      }
    };
    load(0);
    for (int64_t base = 0; base < p; base += kAhead) {
      // the block's inserts, compacted in column order, then two sentinels
      // (id 0 after the head) that the reads ahead may touch
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kAhead / 32; ++u) {
        const unsigned m = __ballot_sync(kAll, nkd[u] == kInsert);
        if (nkd[u] == kInsert)
          s_ins[cnt + __popc(m & lt)] = make_int2(nk[u], nr[u]);
        cnt += __popc(m);
      }
      if (lane < 2) s_ins[cnt + lane] = make_int2(0, kHead);
      __syncwarp();
      load(base + kAhead);          // the next block, behind the walk
      if (lane == 0 && cnt) {
        // insert k's id, cursor and links (j = X[cur], ej = E[j]); the next
        // insert's links are read before this splice lands, then corrected
        // from the three cells it writes; its (id, referent) two ahead
        int2 now = s_ins[0];
        int32_t pk = now.x, cur = now.y;
        int32_t j = X[cur];
        int32_t ej = E[j];
        int2 next = s_ins[1];
        for (int k = 0; k < cnt; ++k) {
          const int32_t pk_n = next.x, cur_n = next.y;
          next = s_ins[k + 2];
          int32_t j_n = X[cur_n];
          int32_t ej_n = E[j_n];
          for (int32_t h = 0; ej > pk && h < hops; ++h) {
            cur = j;
            j = X[j];
            ej = E[j];
          }
          X[slot] = static_cast<XT>(j);
          X[cur] = static_cast<XT>(slot);
          E[slot] = pk;
          const bool after = cur_n == slot;
          j_n = cur_n == cur ? slot : after ? j : j_n;
          ej_n = j_n == slot ? pk : after ? ej : ej_n;
          pk = pk_n;
          cur = cur_n;
          j = j_n;
          ej = ej_n;
          ++slot;
        }
      }
      __syncwarp();
    }
  } else if (warp == 1) {
    // ---- phase C: the register updates, grouped by node
    int32_t* c_kind = stage + 2 * (kAhead + 2);
    int32_t* c_pk = c_kind + 32;
    int32_t* c_vl = c_pk + 32;
    int32_t* c_pr = c_vl + 32;
    int64_t ins_seen = 0;
    bool bad = false;
    int32_t nkd = kPad, nnode = -1, npk = 0, nvl = 0, npr[kMaxPreds];
    auto load = [&](int64_t i) {
      nkd = kPad;
      if (i < p) {
        const int64_t o = op0 + i;
        nkd = kind[o];
        nnode = A[i];
        npk = packed[o];
        nvl = value[o];
#pragma unroll
        for (int q = 0; q < kMaxPreds; ++q)
          if (q < d) npr[q] = preds[o * d + q];
      }
    };
    load(lane);
    for (int64_t base = 0; base < p; base += 32) {
      const int32_t kd = nkd;
      const bool is_ins = kd == kInsert;
      const unsigned im = __ballot_sync(kAll, is_ins);
      const int32_t node = is_ins ? static_cast<int32_t>(
                                        base_slot + ins_seen + __popc(im & lt))
                                  : nnode;
      ins_seen += __popc(im);
      const bool go = kd >= kInsert && kd <= kInc && node >= 0;
      c_kind[lane] = kd;
      c_pk[lane] = npk;
      c_vl[lane] = nvl;
#pragma unroll
      for (int q = 0; q < kMaxPreds; ++q)
        if (q < d) c_pr[lane * kMaxPreds + q] = npr[q];
      load(base + 32 + lane);       // the next chunk, behind this one's work
      // nodes are below 2^31: a negative key per lane keeps the rest apart
      const unsigned grp = __match_any_sync(
          kAll, go ? static_cast<unsigned>(node) : 0x80000000u | lane);
      __syncwarp();
      if (go && lane == __ffs(grp) - 1) {
        for (unsigned g = grp; g; g &= g - 1) {
          const int q = __ffs(g) - 1;
          bad |= apply_registers(L, c_kind[q], c_pk[q], c_vl[q],
                                 c_pr + q * kMaxPreds, d, node);
        }
      }
      __syncwarp();
    }
    if (__any_sync(kAll, bad) && lane == 0) s_bad = 1;
  }
  __syncthreads();

  const int64_t n_final = serial ? s_nd : n0 + ins_total;
  if constexpr (kResident) {
    if (!serial)
      for (int64_t v = tid; v < nodes; v += kThreads)
        gX[v] = static_cast<int32_t>(X[v]);
    for (int64_t v = base_slot + tid; v < kSlot0 + n_final; v += kThreads)
      gE[v] = E[v];
  }
  if (tid == 0) {
    n_alloc[doc] = static_cast<int32_t>(n_final);
    inexact[doc] = was_inexact || s_bad;
    if (s_applied) atomicAdd(stats, s_applied);
    if (serial) atomicAdd(stats + 1, 1);
  }
}

}  // namespace

// Lets the kernel's CTAs take up to max_smem_bytes of dynamic shared memory
// (above the 48 KB default this must be asked for) and the largest
// shared-memory carveout on the current device. seq_kernel.py calls it once
// per device. Returns the CUDA error code (0 = cudaSuccess).
extern "C" int seq_scan_setup(int max_smem_bytes) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(seq_scan_kernel<true>),
      reinterpret_cast<const void*>(seq_scan_kernel<false>)};
  cudaError_t err = cudaSuccess;
  for (const void* k : kernels) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
  }
  return static_cast<int>(err);
}

// Applies the batch to the rows in place (see above) along `route` (0 =
// resident, 1 = global; seq_kernel._launch_plan), one CTA per row with
// smem_bytes of dynamic shared memory; adds the applied-op count to
// stats[0] and the serial rows to stats[1] (int32). `aux` is [rows, p] int32
// scratch. Each row's table has t_size = table_entries(nodes - 3) entries:
// in shared memory on the resident route, else in `table` (rows x t_size
// uint32 of scratch). Returns the CUDA error code of the launch (0 =
// cudaSuccess); an argument the kernel cannot take returns
// cudaErrorInvalidValue.
extern "C" int seq_scan_launch(
    void* elem_id, void* nxt, void* reg, void* killed, void* val,
    void* counter, void* n_alloc, void* inexact, const void* kind,
    const void* ref, const void* packed, const void* value, const void* preds,
    const void* flag, void* stats, void* aux, void* table, int64_t rows,
    int64_t nodes, int64_t a, int64_t p, int64_t d, int64_t t_size,
    int route, int64_t smem_bytes, void* stream) {
  if (rows <= 0 || p <= 0) return 0;
  if (d < 0 || d > kMaxPreds || nodes < 4 || nodes > INT_MAX || a < 1 ||
      a > 256 || p > INT_MAX || rows > INT_MAX ||
      t_size != table_entries(nodes - 3) || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0 && (nodes > kMaxResidentNodes ||
                     smem_bytes < resident_bytes(nodes) + kStageBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes < kStageBytes) return static_cast<int>(cudaErrorInvalidValue);
  const auto strm = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(rows);
  const auto shared = static_cast<size_t>(smem_bytes);
#define SEQ_SCAN_ARGS                                                        \
  static_cast<int32_t*>(elem_id), static_cast<int32_t*>(nxt),                \
      static_cast<int32_t*>(reg), static_cast<uint8_t*>(killed),             \
      static_cast<int32_t*>(val), static_cast<int32_t*>(counter),            \
      static_cast<int32_t*>(n_alloc), static_cast<uint8_t*>(inexact),        \
      static_cast<const int32_t*>(kind), static_cast<const int32_t*>(ref),   \
      static_cast<const int32_t*>(packed),                                   \
      static_cast<const int32_t*>(value),                                    \
      static_cast<const int32_t*>(preds), static_cast<const uint8_t*>(flag), \
      static_cast<int32_t*>(stats), static_cast<int32_t*>(aux),              \
      static_cast<uint32_t*>(table), nodes, a, p, d, t_size
  if (route == 0)
    seq_scan_kernel<true><<<grid, kThreads, shared, strm>>>(SEQ_SCAN_ARGS);
  else
    seq_scan_kernel<false><<<grid, kThreads, shared, strm>>>(SEQ_SCAN_ARGS);
#undef SEQ_SCAN_ARGS
  return static_cast<int>(cudaGetLastError());
}
