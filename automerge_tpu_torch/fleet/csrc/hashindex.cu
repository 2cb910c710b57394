// Batched insert into, and probe of, the frontier index's open-addressing
// hash table, for Hopper (sm_90a).
//
// Replaces two jax.jit kernels of automerge_tpu/fleet/hashindex.py:
//   hashindex_insert <- _insert_kernel (:221)
//   hashindex_probe  <- _probe_kernel (:264)
// The table is tkey [cap, 8] uint32 (a 32-byte change hash as eight
// little-endian words) and tspace [cap] int32 (the key's namespace, -1 =
// empty slot); cap is a power of two. A (space, key) pair starts at
//   (key[0] ^ (uint32(space) * 0x9E3779B9)) & (cap - 1)
// (hashindex.py _start_pos, :215) and probes linearly, wrapping at cap.
// Slots are never emptied in place (dead spaces stay until a migration),
// so a walk that reaches an empty slot is conclusive.
//
// What bounds them on this card. Latency and the memory system's
// ordering work, not bytes. A row's walk is a chain of dependent accesses
// to scattered sectors of a table (75.5 MB at 2^21 slots) that does not
// fit the 50 MB L2; the bytes a call must move (each row's key, space and
// flag, the sectors of its start slots, and one key and space per new
// key) are a small part of its time. An insert adds its own protocol to
// the walk: the claim (an atomic at the L2), the key's stores, and the
// publication that orders them before the space. On an H100 at the sync
// path's shape (800,000 new keys into 2^21 slots), taking each of these
// out in turn showed the ordering costing the most, then the claims, then
// the key stores.
//
// The insert. One thread per row, so ~1M walks are in flight at once and
// their round trips overlap. A step reads the aligned 8-slot sector that
// holds the walk's position (two 16-byte loads, one 32-byte sector) and
// walks it from there, so at the table's load (<= 0.6) most walks end in
// one step. The row's flag, key and space come in one round trip. The
// thread claims the first empty slot in walk order (any later one would
// leave an empty slot before the key, where both probes stop) with
// atomicCAS(-1 -> kBusy) and writes the 32-byte key as two 16-byte
// stores. The warp walks in turns: after each turn it publishes every
// slot its threads claimed with one fence.acq_rel.gpu and a relaxed store
// of each space (a release pattern: the keys become visible before their
// spaces), so the ordering is paid once per warp and turn, not once per
// thread. A walker that meets a claimed slot (kBusy, or a lost claim)
// looks at it again next turn, since it may hold the row's own key; a
// space match is re-read with an acquire load, which orders the key's
// plain 16-byte loads behind the publication. A key already published, or
// an in-batch twin, is found before any empty slot, so duplicates land
// once. The count of new keys is one atomicAdd per CTA. The walk ends
// because the caller keeps the table's load at or below load_max < 1
// (HashIndex._ensure_capacity; the wrapper checks it). Which of two
// in-batch claimants wins a slot is a race, so the slot layout may differ
// from the JAX kernel's (where the lowest row wins); membership, the
// count of new keys and the table's length do not.
//
// Two other designs were built and timed on an H100 at that shape, and
// both were slower: a group of 8 threads per row (one slot each, ballots,
// the key compared a word per thread), since one thread per row keeps 8x
// as many rows' round trips in flight; and a release store per thread in
// place of the warp's fence.
//
// The probe. One thread per row, so ~1M independent walks are in flight.
// A walk reads the row's flag, space and first key half together (the
// start slot needs only word 0), then the start slot's space beside the
// key's second half, then the slot's 32-byte key where the space is the
// row's, and one slot more at a time until an empty slot or the key. What
// bounds it on this card is the memory system, not the chain's length:
// the valid rows stream ~30 MB, and each found key is a scattered 32-byte
// read of a 64 MB key half that does not fit the L2. What helped was the
// L2's eviction priority: the table's spaces (8 MB) are read with
// evict_last and its keys with evict_first, so the key traffic does not
// push the spaces out and a space read is mostly an L2 hit; the row's
// flag and space are read, and its answer stored, with streaming hints.
// Built and timed at the sync path's shape, and slower (PERF.md §6): the
// start slot's key loaded speculatively with its space; the start slot's
// 8-slot sector of spaces walked in registers, as the insert does; two or
// four rows a thread. Streaming hints on the row's key halves too were
// faster with the L2 warm and slower after an eviction, so they are left
// out. The JAX kernels gather a fixed window of slots and loop in
// whole-batch steps because XLA on the CPU pays ~0.1 ms per while_loop
// iteration; here a thread simply walks its own chain.
//
// Built by cuda_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers), bound with ctypes in sync_kernels.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kEmpty = -1;
constexpr int32_t kBusy = -2;    // claimed, key not yet published
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint32_t start_pos(uint32_t word0, int32_t space,
                                              uint32_t mask) {
  return (word0 ^ (static_cast<uint32_t>(space) * kGold)) & mask;
}

__device__ __forceinline__ void load_key(const uint32_t* keys, int64_t row,
                                         uint32_t k[8]) {
  const uint4* src = reinterpret_cast<const uint4*>(keys + row * 8);
  const uint4 a = src[0], b = src[1];
  k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
  k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
}

__device__ __forceinline__ int32_t load_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int4 load_volatile4(const int32_t* p) {
  int4 v;
  asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(int32_t* p, int32_t v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// With a relaxed store after it, a release: the thread's earlier writes
// become visible before that store to any thread that acquires it.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
hashindex_insert_kernel(uint32_t* tkey, int32_t* tspace, uint32_t mask,
                        const uint32_t* __restrict__ keys,
                        const int32_t* __restrict__ spaces,
                        const uint8_t* __restrict__ valid, int64_t n,
                        int32_t* n_new) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  uint32_t k[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int32_t space = 0;
  bool done = true;
  if (row < n) {
    // the flag, key and space in one round trip (padding rows are zeros)
    done = !valid[row];
    load_key(keys, row, k);
    space = spaces[row];
  }
  uint32_t pos = start_pos(k[0], space, mask);
  bool inserted = false, publish = false;
  uint32_t claimed = 0;
  // A warp-wide loop: each turn, every thread still walking takes one
  // step; then the warp publishes the slots its threads claimed, behind
  // one fence for the warp.
  while (__any_sync(kAll, !done)) {
    if (!done) {
      const uint32_t base = pos & ~7u;
      const int4 lo = load_volatile4(tspace + base);
      const int4 hi = load_volatile4(tspace + base + 4);
      const int32_t sec[8] = {lo.x, lo.y, lo.z, lo.w,
                              hi.x, hi.y, hi.z, hi.w};
      bool wait = false;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (done || wait || base + i < pos) continue;
        const uint32_t slot = base + i;
        int32_t s = sec[i];
        if (s == kEmpty) {
          s = atomicCAS(tspace + slot, kEmpty, kBusy);
          if (s == kEmpty) {
            uint4* dst = reinterpret_cast<uint4*>(tkey + slot * 8ull);
            dst[0] = make_uint4(k[0], k[1], k[2], k[3]);
            dst[1] = make_uint4(k[4], k[5], k[6], k[7]);
            claimed = slot;
            inserted = publish = done = true;
            continue;
          }
          // lost the claim: the winner's space or kBusy, looked at below
        }
        if (s == kBusy) {             // look again next turn
          pos = slot;
          wait = true;
          continue;
        }
        if (s == space && load_acquire(tspace + slot) == space) {
          const uint4* src =
              reinterpret_cast<const uint4*>(tkey + slot * 8ull);
          const uint4 a = src[0], b = src[1];
          done = a.x == k[0] && a.y == k[1] && a.z == k[2] && a.w == k[3] &&
                 b.x == k[4] && b.y == k[5] && b.z == k[6] && b.w == k[7];
        }
      }
      if (!done && !wait) pos = (base + 8) & mask;
    }
    if (__any_sync(kAll, publish)) {
      fence_acq_rel();
      if (publish) store_relaxed(tspace + claimed, space);
      publish = false;
    }
  }
  const int count = __syncthreads_count(inserted);
  if (threadIdx.x == 0 && count) atomicAdd(n_new, count);
}

// Loads with an L2 eviction priority (createpolicy + ld.L2::cache_hint).
// The probe reads its table's spaces (8 MB at 2^21 slots, worth keeping)
// with evict_last and its keys (64 MB, read once a row, scattered) with
// evict_first, so the key traffic does not push the spaces out of the L2.
__device__ __forceinline__ int32_t load_evict_last(const int32_t* p) {
  uint64_t policy;
  int32_t v;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
      : "=l"(policy));
  asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint4 load_evict_first(const uint4* p) {
  uint64_t policy;
  uint4 v;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(policy));
  asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ bool same_key(const uint32_t k[8], uint4 a,
                                         uint4 b) {
  return a.x == k[0] && a.y == k[1] && a.z == k[2] && a.w == k[3] &&
         b.x == k[4] && b.y == k[5] && b.z == k[6] && b.w == k[7];
}

// The walk of one probe row from slot `pos`, whose space `s` is already
// loaded, and whose key (a, b) is loaded where `s` is the row's space:
// slots in order until an empty one (absent) or the key (found).
__device__ bool probe_walk(const uint32_t* tkey, const int32_t* tspace,
                           uint32_t mask, const uint32_t k[8], int32_t space,
                           uint32_t pos, int32_t s, uint4 a, uint4 b) {
  for (;;) {
    if (s == kEmpty) return false;
    if (s == space && same_key(k, a, b)) return true;
    pos = (pos + 1) & mask;
    s = load_evict_last(tspace + pos);
    if (s == space) {
      const uint4* src = reinterpret_cast<const uint4*>(tkey + pos * 8ull);
      a = load_evict_first(src);
      b = load_evict_first(src + 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hashindex_probe_kernel(const uint32_t* __restrict__ tkey,
                       const int32_t* __restrict__ tspace, uint32_t mask,
                       const uint32_t* __restrict__ keys,
                       const int32_t* __restrict__ spaces,
                       const uint8_t* __restrict__ valid, int64_t n,
                       uint8_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= n) return;
  // the row's flag, space and first key half in one round trip; a row that
  // is not valid reads nothing more. The flag and space stream past the L2.
  const uint4* src = reinterpret_cast<const uint4*>(keys + row * 8);
  const bool live = __ldcs(valid + row) != 0;
  const int32_t space = __ldcs(spaces + row);
  const uint4 x = src[0];
  bool found = false;
  if (live) {
    // the start slot's space and the key's second half, together
    const uint32_t pos = start_pos(x.x, space, mask);
    const int32_t s = load_evict_last(tspace + pos);
    const uint4 y = src[1];
    const uint32_t k[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
    uint4 a = {}, b = {};
    if (s == space && s != kEmpty) {
      const uint4* key = reinterpret_cast<const uint4*>(tkey + pos * 8ull);
      a = load_evict_first(key);
      b = load_evict_first(key + 1);
    }
    found = probe_walk(tkey, tspace, mask, k, space, pos, s, a, b);
  }
  __stcs(out + row, static_cast<uint8_t>(found));
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Inserts the valid rows of (spaces [n] int32, keys [n, 8] uint32) into
// the table (tkey [cap, 8], tspace [cap], cap a power of two >= 8) in
// place and adds the number of keys newly landed to *n_new. Returns the
// CUDA error code of the launch (0 = cudaSuccess).
extern "C" int hashindex_insert_launch(void* tkey, void* tspace, int64_t cap,
                                       const void* keys, const void* spaces,
                                       const void* valid, int64_t n,
                                       void* n_new, void* stream) {
  if (n <= 0) return 0;
  if (cap < 8) return static_cast<int>(cudaErrorInvalidValue);
  hashindex_insert_kernel<<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(tkey), static_cast<int32_t*>(tspace),
      static_cast<uint32_t>(cap - 1), static_cast<const uint32_t*>(keys),
      static_cast<const int32_t*>(spaces), static_cast<const uint8_t*>(valid),
      n, static_cast<int32_t*>(n_new));
  return static_cast<int>(cudaGetLastError());
}

// out[row] = the valid row's (space, key) is in the table ([n] bool).
// Returns the CUDA error code of the launch.
extern "C" int hashindex_probe_launch(const void* tkey, const void* tspace,
                                      int64_t cap, const void* keys,
                                      const void* spaces, const void* valid,
                                      int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  hashindex_probe_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tkey), static_cast<const int32_t*>(tspace),
      static_cast<uint32_t>(cap - 1), static_cast<const uint32_t*>(keys),
      static_cast<const int32_t*>(spaces), static_cast<const uint8_t*>(valid),
      n, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
