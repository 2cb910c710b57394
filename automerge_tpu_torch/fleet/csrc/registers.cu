// The multi-value register scan, for Hopper (sm_90a).
//
// Replaces the ordered scan of automerge_tpu/fleet/registers.py
// (_apply_register_batch_impl :207, one lax.scan step _apply_step :106 per
// op column). The state is actor-slotted:
//   reg, value, counter [N, K+1, A] int32, killed [N, K+1, A] uint8,
//   inexact [N] uint8;
// the batch is kind/key_id/packed/value [N, P] int32, preds [N, P, D]
// int32 and overflow [N, P] uint8. register_kernel.py states the rules of
// one op; this kernel applies them, in place, and adds the number of
// non-PAD lanes to *applied.
//
// Layout. One thread per document. A doc's ops are ordered (a successor
// can land in the same batch as the op it kills) and documents are
// independent, so each thread walks its own P ops in order. An op touches
// only the slots its D preds and its own actor name, so a thread reads and
// writes those cells in place, where the JAX step gathers and scatters a
// whole [A] row per op. The doc's `inexact` flag lives in a register and
// is stored once. Offsets are int64: at A = 256 a large fleet passes 2^31
// cells.
//
// What bounds it on this card. Latency, not bytes: each op is a short
// chain of dependent loads (its columns, then the pred'd slots, then its
// own slot) on cells scattered over a state far larger than the L2, and
// a fleet of N docs has only N threads in flight. The cells an op may
// touch are few (D + 1 slots of one [A] row), so the bytes the batch must
// move are small beside the state's size. A warp per doc, or staging a
// doc's op columns in shared memory to coalesce their loads, is later
// work.
//
// Corners kept exactly as the JAX step computes them:
// - the kill and "lose" loops update `killed` lane by lane, so duplicate
//   pred lanes give the same result;
// - the inc's max pred is a signed max from 0 over every non-zero pred,
//   even one whose slot is >= A (a dead or out-of-range max pred consumes
//   the inc silently; an inc with no live pred hit flags the doc);
// - the counter add wraps in int32 (done in uint32) and is dropped at
//   slot >= A;
// - the JAX step reads the set's own slot with a clamped gather when the
//   actor is >= A; only the self-conflict test reads it, and that op
//   flags the doc anyway, so the kernel skips the read (no out-of-bounds
//   access) and the state comes out equal;
// - the self-conflict test compares zero pred lanes too, gated by a
//   non-zero standing op, as the JAX step does.
//
// Built by cuda_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers), bound with ctypes in register_kernel.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;     // small CTAs spread a 10k-doc fleet's
                                 // threads over every SM
constexpr int32_t kPad = 0, kSet = 1, kInc = 3;
constexpr int32_t kActorMask = 255;
constexpr unsigned kAll = 0xffffffffu;

__global__ void register_scan_kernel(
    int32_t* __restrict__ reg, uint8_t* __restrict__ killed,
    int32_t* __restrict__ value, int32_t* __restrict__ counter,
    uint8_t* __restrict__ inexact, const int32_t* __restrict__ kind,
    const int32_t* __restrict__ key_id, const int32_t* __restrict__ packed,
    const int32_t* __restrict__ val, const int32_t* __restrict__ preds,
    const uint8_t* __restrict__ overflow, int32_t* __restrict__ applied,
    int64_t n, int64_t p, int64_t d, int64_t k1, int64_t a) {
  const int64_t doc = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int count = 0;
  if (doc < n) {
    bool flag = inexact[doc] != 0;
    for (int64_t i = 0; i < p; ++i) {
      const int64_t o = doc * p + i;
      const int32_t kd = kind[o];
      flag |= overflow[o] != 0;
      if (kd == kPad) continue;
      ++count;
      const int32_t k = key_id[o];
      if (k < 0 || k >= k1) {        // outside the grid: see register_kernel
        flag = true;
        continue;
      }
      const int64_t row = (doc * k1 + k) * a;
      const int32_t* pr = preds + o * d;
      if (kd != kInc) {
        // pred kills, lane by lane
        for (int64_t j = 0; j < d; ++j) {
          const int32_t pj = pr[j];
          if (pj == 0) continue;
          const int32_t s = pj & kActorMask;
          if (s >= a) {
            flag = true;
            continue;
          }
          if (reg[row + s] == pj) killed[row + s] = 1;
        }
      } else {
        // inc: credit the Lamport-max pred iff live, kill the other live
        // preds; no kills before this point, so `killed` is the op's input
        int32_t max_pred = 0;
        bool any_live_hit = false;
        for (int64_t j = 0; j < d; ++j) {
          const int32_t pj = pr[j];
          if (pj == 0) continue;
          max_pred = max(max_pred, pj);
          const int32_t s = pj & kActorMask;
          if (s >= a) {
            flag = true;
            continue;
          }
          if (reg[row + s] == pj && !killed[row + s]) any_live_hit = true;
        }
        const int32_t sm = max_pred & kActorMask;
        const bool max_live = max_pred != 0 && sm < a &&
                              reg[row + sm] == max_pred && !killed[row + sm];
        if (max_live) {
          counter[row + sm] = static_cast<int32_t>(
              static_cast<uint32_t>(counter[row + sm]) +
              static_cast<uint32_t>(val[o]));
        }
        for (int64_t j = 0; j < d; ++j) {
          const int32_t pj = pr[j];
          if (pj == 0 || pj == max_pred) continue;
          const int32_t s = pj & kActorMask;
          if (s >= a) continue;
          if (reg[row + s] == pj && !killed[row + s]) killed[row + s] = 1;
        }
        if (!(any_live_hit || max_live)) flag = true;
      }
      const int32_t pk = packed[o];
      const int32_t own = pk & kActorMask;
      if (own >= a) {                // actor beyond the slot width
        flag = true;
        continue;
      }
      if (kd == kSet) {
        const int64_t c = row + own;
        const int32_t prev = reg[c];
        if (prev != 0 && !killed[c] && prev != pk) {
          bool own_pred = false;
          for (int64_t j = 0; j < d; ++j) own_pred |= pr[j] == prev;
          if (!own_pred) flag = true;  // self-conflict
        }
        reg[c] = pk;
        killed[c] = 0;
        value[c] = val[o];
        counter[c] = 0;
      }
    }
    inexact[doc] = flag;
  }
  // one atomic per CTA for the non-PAD lane count
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(kAll, count, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_sums[w];
    if (sum) atomicAdd(applied, sum);
  }
}

}  // namespace

// Applies the batch to the state in place (see above) and adds the number
// of non-PAD lanes to *applied (int32). Returns the CUDA error code of the
// launch (0 = cudaSuccess).
extern "C" int register_scan_launch(
    void* reg, void* killed, void* value, void* counter, void* inexact,
    const void* kind, const void* key_id, const void* packed, const void* val,
    const void* preds, const void* overflow, void* applied, int64_t n,
    int64_t p, int64_t d, int64_t k1, int64_t a, void* stream) {
  if (n <= 0 || p <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  register_scan_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(reg), static_cast<uint8_t*>(killed),
      static_cast<int32_t*>(value), static_cast<int32_t*>(counter),
      static_cast<uint8_t*>(inexact), static_cast<const int32_t*>(kind),
      static_cast<const int32_t*>(key_id), static_cast<const int32_t*>(packed),
      static_cast<const int32_t*>(val), static_cast<const int32_t*>(preds),
      static_cast<const uint8_t*>(overflow), static_cast<int32_t*>(applied),
      n, p, d, k1, a);
  return static_cast<int>(cudaGetLastError());
}
