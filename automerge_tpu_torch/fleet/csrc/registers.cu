// The multi-value register scan, for Hopper (sm_90a).
//
// Replaces the ordered scan of automerge_tpu/fleet/registers.py
// (_apply_register_batch_impl :207, one lax.scan step _apply_step :106 per
// op column). The state is actor-slotted:
//   reg, value, counter [N, K+1, A] int32, killed [N, K+1, A] uint8,
//   inexact [N] uint8;
// the batch is kind/key_id/packed/value [N, P] int32, preds [N, P, D]
// int32 and overflow [N, P] uint8. register_kernel.py states the rules of
// one op; this kernel applies them, in place, and writes the number of
// non-PAD lanes to *applied.
//
// What bounds it on this card. Scattered accesses, not bytes: an op reads
// two to a few cells of one [A] row of a state far larger than the L2 and
// writes three or four cells of other arrays of the same row, so a batch
// of 200,000 ops is ~10^6 scattered 4-byte accesses, each its own sector
// request, while the bytes it must move are ~10 MB. The parent design, a
// thread per doc walking its ops in order, also paid 60-80 dependent round
// trips per thread with only N threads in flight. On an H100 the time
// follows the number of accesses and where they land: the same batch with
// each doc's keys spread at random takes ~3x as long (PERF.md §6).
//
// Layout. Ops of one doc interact only through the row of the key they
// name, (doc, key), and through the doc's `inexact` OR: ops on different
// keys commute. So each doc takes a segment of w lanes of a warp (w = 32
// when P > 16, else the power of two >= P, and 32 / w docs share a warp),
// and lane i takes op column i of a tile of w columns; tiles run in
// order. The op columns and the first kD preds of a tile load coalesced
// in one round trip. The tile's live lanes whose key lies in the grid are
// grouped by row with __match_any_sync and applied in rounds: round r runs
// the lanes that have r earlier lanes of the same row in the tile, so the
// lanes of one key apply in column order and lanes of distinct rows apply
// at once; a __syncwarp() between rounds makes each round's stores
// visible to the next. On the exact seam (20 random keys of 1,000 per
// doc) a tile is one round. register_kernel.register_scan_rounds_plain
// applies the same schedule in torch ops, held to the JAX scan on the
// CPU.
//
// One op is one round trip: every address it reads is known from its
// columns (its preds' slots, its own slot, the counter cell of an inc's
// Lamport-max pred), so all its loads go out together, it decides in
// registers, and it stores only the cells that change. It reads exactly
// the cells it needs: reading the [A] row whole with vector loads (32 +
// 8 B at A = 8) was slower on an H100, since the scan is bound by the
// number of scattered accesses, not by their bytes (PERF.md §6). Preds
// past the first kD are read in chunks of kD from global memory (the
// fleet's D is 4).
//
// The count of non-PAD lanes needs no zeroed output: each CTA adds
// (1 << 32) | its count to a 64-bit word with one atomic, and the CTA
// that arrives last writes the sum to *applied and resets the word to 0
// for the next launch (the wrapper keeps one such word per stream).
//
// Corners kept exactly as the JAX step computes them:
// - kills and the inc's "lose" kills update `killed` lane by lane; both
//   only set bits, and a later duplicate pred lane meets the same cell, so
//   deciding every pred lane on the cells as they stood before the op
//   gives the same state;
// - the inc's max pred is a signed max from 0 over every non-zero pred,
//   even one whose slot is >= A (a dead or out-of-range max pred consumes
//   the inc silently; an inc with no live pred hit flags the doc);
// - the counter add wraps in int32 (done in uint32) and is dropped at
//   slot >= A;
// - the JAX step reads the set's own slot with a clamped gather when the
//   actor is >= A; only the self-conflict test reads it, and that op
//   flags the doc anyway, so the kernel skips the read (no out-of-bounds
//   access) and the state comes out equal;
// - the self-conflict test compares every pred lane with the standing op,
//   zero lanes and lanes whose slot is >= A included, gated by a
//   non-zero standing op, as the JAX step does;
// - `overflow` flags the doc on every lane, PAD lanes included;
// - a live lane whose key lies outside [0, K] flags the doc, joins no
//   round and writes nothing.
//
// Built by cuda_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers), bound with ctypes in register_kernel.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kD = 4;                    // pred lanes held in registers
constexpr int32_t kPad = 0, kSet = 1, kInc = 3;
constexpr int32_t kActorMask = 255;
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  int32_t* reg;
  uint8_t* killed;
  int32_t* value;
  int32_t* counter;
  uint8_t* inexact;
  const int32_t* kind;
  const int32_t* key_id;
  const int32_t* packed;
  const int32_t* val;
  const int32_t* preds;
  const uint8_t* overflow;
  int32_t* applied;
  unsigned long long* arrivals;
  int64_t n, p, d, k1;
  int32_t a;
  int w_shift;                           // lanes per doc = 1 << w_shift
};

__device__ __forceinline__ int32_t pred_at(const int32_t (&p0)[kD],
                                           const int32_t* pr, int64_t d,
                                           int64_t c, int j) {
  if (c == 0) return p0[j];
  return c + j < d ? pr[c + j] : 0;
}

// Applies one live op whose key lies in the grid to its row (cells from
// `base`, the row's offset). Returns whether it flags the doc.
__device__ bool apply_op(const Args& g, int64_t base, int32_t kd,
                         int32_t pk, int32_t v, const int32_t (&p0)[kD],
                         const int32_t* pr) {
  const int32_t a = g.a;
  const int64_t d = g.d;
  bool flag = false;
  // the inc's Lamport-max pred: a signed max from 0 over non-zero preds
  int32_t max_pred = 0;
  if (kd == kInc) {
    for (int64_t c = 0; c < d; c += kD) {
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const int32_t pj = pred_at(p0, pr, d, c, j);
        if (pj != 0) max_pred = max(max_pred, pj);
      }
    }
  }
  const int32_t own = pk & kActorMask;
  const int32_t sm = max_pred & kActorMask;
  // every read of the op, sent out together
  int32_t r_own = 0;
  bool k_own = false;
  if (own < a) {
    r_own = g.reg[base + own];
    k_own = g.killed[base + own] != 0;
  }
  int32_t c_max = 0;
  if (kd == kInc && max_pred != 0 && sm < a) c_max = g.counter[base + sm];
  bool hit_own = false, own_pred = false, any_live = false, max_live = false;
  for (int64_t c = 0; c < d; c += kD) {
    int32_t p[kD], r[kD];
    bool k[kD];
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      p[j] = pred_at(p0, pr, d, c, j);
      const int32_t s = p[j] & kActorMask;
      const bool in = p[j] != 0 && s < a;
      r[j] = in ? g.reg[base + s] : 0;
      k[j] = in && g.killed[base + s] != 0;
    }
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      const int32_t pj = p[j];
      if (pj == 0) continue;
      own_pred |= pj == r_own;
      const int32_t s = pj & kActorMask;
      if (s >= a) {
        flag = true;
        continue;
      }
      if (kd != kInc) {                  // a pred kill
        const bool hit = r[j] == pj;
        if (hit && !k[j]) g.killed[base + s] = 1;
        hit_own |= hit && s == own;
      } else {                           // credit the max, kill the rest
        const bool live = r[j] == pj && !k[j];
        any_live |= live;
        if (pj == max_pred) {
          max_live |= live;
        } else if (live) {
          g.killed[base + s] = 1;
        }
      }
    }
  }
  if (kd == kInc) {
    if (max_live) {
      g.counter[base + sm] = static_cast<int32_t>(
          static_cast<uint32_t>(c_max) + static_cast<uint32_t>(v));
    }
    if (!any_live) flag = true;          // no live pred hit
  }
  if (own >= a) return true;             // actor beyond the slot width
  if (kd == kSet) {
    const bool dead = k_own || hit_own;
    if (r_own != 0 && !dead && r_own != pk && !own_pred)
      flag = true;                       // self-conflict
    const int64_t cell = base + own;
    g.reg[cell] = pk;
    if (dead) g.killed[cell] = 0;
    g.value[cell] = v;
    g.counter[cell] = 0;
  }
  return flag;
}

__global__ void __launch_bounds__(kThreads) register_scan_kernel(Args g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = 1 << g.w_shift;
  const int seg = lane >> g.w_shift;
  const int col0 = lane & (w - 1);
  const int64_t doc =
      ((static_cast<int64_t>(blockIdx.x) * kWarps + warp) << (5 - g.w_shift))
      + seg;
  const bool doc_ok = doc < g.n;
  const unsigned earlier = (1u << lane) - 1;
  bool flag = false;
  unsigned count = 0;
  for (int64_t t = 0; t < g.p; t += w) {   // tiles, in order
    const int64_t col = t + col0;
    const int64_t o = doc * g.p + col;
    int32_t kd = kPad, k = 0, pk = 0, v = 0;
    int32_t p0[kD] = {};
    if (doc_ok && col < g.p) {
      kd = g.kind[o];
      k = g.key_id[o];
      pk = g.packed[o];
      v = g.val[o];
      flag |= g.overflow[o] != 0;
#pragma unroll
      for (int j = 0; j < kD; ++j)
        if (j < g.d) p0[j] = g.preds[o * g.d + j];
    }
    const bool live = kd != kPad;
    const bool in_grid = k >= 0 && k < g.k1;
    if (live && !in_grid) flag = true;   // outside the grid: writes nothing
    const bool joins = live && in_grid;
    count += __popc(__ballot_sync(kAll, live));
    const int64_t row = doc * g.k1 + k;
    const unsigned peers = __match_any_sync(
        kAll, joins ? static_cast<unsigned long long>(row) : ~0ull - lane);
    const unsigned rank = __popc(peers & earlier);
    const unsigned rounds = __reduce_max_sync(kAll, joins ? rank + 1 : 0);
    for (unsigned r = 0; r < rounds; ++r) {
      if (joins && rank == r)
        flag |= apply_op(g, row * g.a, kd, pk, v, p0, g.preds + o * g.d);
      __syncwarp();
    }
  }
  // a doc's flag rises once, from its segment's first lane
  const unsigned flagged = __ballot_sync(kAll, flag);
  const unsigned seg_lanes =
      (w == 32 ? kAll : (1u << w) - 1) << (seg << g.w_shift);
  if (doc_ok && col0 == 0 && (flagged & seg_lanes)) g.inexact[doc] = 1;
  // the non-PAD lane count: one atomic per CTA; the last CTA writes it
  __shared__ unsigned sums[kWarps];
  if (lane == 0) sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += sums[i];
    const unsigned long long old =
        atomicAdd(g.arrivals, (1ull << 32) | total);
    if ((old >> 32) == gridDim.x - 1u) {
      *g.applied = static_cast<int32_t>(static_cast<uint32_t>(old) + total);
      *g.arrivals = 0;                   // ready for the next launch
    }
  }
}

}  // namespace

// Applies the batch to the state in place (see above) and writes the
// number of non-PAD lanes to *applied (int32). `arrivals` is a uint64 word
// that is 0 before the launch and is 0 again after it; launches that share
// one may not run concurrently. n * p must stay below 2^31. Returns the
// CUDA error code of the launch (0 = cudaSuccess).
extern "C" int register_scan_launch(
    void* reg, void* killed, void* value, void* counter, void* inexact,
    const void* kind, const void* key_id, const void* packed, const void* val,
    const void* preds, const void* overflow, void* applied, void* arrivals,
    int64_t n, int64_t p, int64_t d, int64_t k1, int64_t a, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  if (a <= 0 || a > 256 || n * p >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int w_shift = 5;
  while (w_shift > 0 && (1ll << (w_shift - 1)) >= p) --w_shift;
  const int64_t docs_per_cta = static_cast<int64_t>(kWarps) << (5 - w_shift);
  const int64_t blocks = (n + docs_per_cta - 1) / docs_per_cta;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Args g{static_cast<int32_t*>(reg), static_cast<uint8_t*>(killed),
               static_cast<int32_t*>(value), static_cast<int32_t*>(counter),
               static_cast<uint8_t*>(inexact),
               static_cast<const int32_t*>(kind),
               static_cast<const int32_t*>(key_id),
               static_cast<const int32_t*>(packed),
               static_cast<const int32_t*>(val),
               static_cast<const int32_t*>(preds),
               static_cast<const uint8_t*>(overflow),
               static_cast<int32_t*>(applied),
               static_cast<unsigned long long*>(arrivals), n, p, d, k1,
               static_cast<int32_t>(a), w_shift};
  register_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
