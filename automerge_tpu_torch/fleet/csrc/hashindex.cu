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
// What bounds them on this card. Latency. A row's walk is a chain of
// dependent loads, a 4 B space and a 32 B key per slot, and at the
// sync round's load (~0.4) a chain is ~1-2 slots long. The table (75.5 MB
// at 2^21 slots) does not fit the 50 MB L2, so each step is a device
// memory round trip on scattered sectors. The bytes a call must move (each
// row's key, space and flag, and one slot per row) are a small part of
// its time.
//
// What the design does about it. One thread per row, so ~1M independent
// walks are in flight at once and their round trips overlap; a row's key
// is loaded once as two 16-byte vectors. The JAX kernels gather a fixed
// window of slots and loop in whole-batch steps because XLA on the CPU
// pays ~0.1 ms per while_loop iteration; here a thread simply walks its
// own chain and stops.
//
// The insert claims an empty slot with atomicCAS(-1 -> kBusy), writes the
// 8 key words, __threadfence(), then publishes the space with a volatile
// store. A walker that meets a busy slot spins on a volatile load until
// the space is published (independent thread scheduling makes this safe
// inside a warp), fences, then compares with volatile loads of the key
// (the L1 is not coherent with other SMs' writes). A walker whose key
// equals a published slot's stops as a duplicate: in-batch duplicates
// and keys already present land once. The count of new keys is one
// atomicAdd per warp of the ballot of the warp's inserts. The walk ends
// because the caller keeps the table's load at or below load_max < 1
// (HashIndex._ensure_capacity; the wrapper checks it). Which of two
// in-batch claimants wins a slot is a race, so the slot layout may differ
// from the JAX kernel's (where the lowest row wins); membership, the
// count of new keys and the table's length do not.
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

__device__ __forceinline__ bool key_equal(const volatile uint32_t* slot,
                                          const uint32_t k[8]) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) eq &= slot[i] == k[i];
  return eq;
}

__global__ void hashindex_insert_kernel(uint32_t* tkey, int32_t* tspace,
                                        uint32_t mask,
                                        const uint32_t* __restrict__ keys,
                                        const int32_t* __restrict__ spaces,
                                        const uint8_t* __restrict__ valid,
                                        int64_t n, int32_t* n_new) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  bool inserted = false;
  if (row < n && valid[row]) {
    uint32_t k[8];
    load_key(keys, row, k);
    const int32_t space = spaces[row];
    volatile int32_t* vspace = tspace;
    volatile uint32_t* vkey = tkey;
    for (uint32_t pos = start_pos(k[0], space, mask);;
         pos = (pos + 1) & mask) {
      int32_t s = vspace[pos];
      if (s == kEmpty) {
        s = atomicCAS(tspace + pos, kEmpty, kBusy);
        if (s == kEmpty) {
          uint4* dst = reinterpret_cast<uint4*>(tkey + pos * 8ull);
          dst[0] = make_uint4(k[0], k[1], k[2], k[3]);
          dst[1] = make_uint4(k[4], k[5], k[6], k[7]);
          __threadfence();
          vspace[pos] = space;
          inserted = true;
          break;
        }
      }
      while (s == kBusy) s = vspace[pos];
      __threadfence();
      if (s == space && key_equal(vkey + pos * 8ull, k)) break;
    }
  }
  const unsigned ballot = __ballot_sync(kAll, inserted);
  if ((threadIdx.x & 31) == 0 && ballot)
    atomicAdd(n_new, __popc(ballot));
}

__global__ void hashindex_probe_kernel(const uint32_t* __restrict__ tkey,
                                       const int32_t* __restrict__ tspace,
                                       uint32_t mask,
                                       const uint32_t* __restrict__ keys,
                                       const int32_t* __restrict__ spaces,
                                       const uint8_t* __restrict__ valid,
                                       int64_t n, uint8_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;
  bool found = false;
  if (valid[row]) {
    uint32_t k[8];
    load_key(keys, row, k);
    const int32_t space = spaces[row];
    for (uint32_t pos = start_pos(k[0], space, mask);;
         pos = (pos + 1) & mask) {
      const int32_t s = tspace[pos];
      if (s == kEmpty) break;
      if (s == space) {
        const uint4* slot = reinterpret_cast<const uint4*>(tkey + pos * 8ull);
        const uint4 a = slot[0], b = slot[1];
        if (a.x == k[0] && a.y == k[1] && a.z == k[2] && a.w == k[3] &&
            b.x == k[4] && b.y == k[5] && b.z == k[6] && b.w == k[7]) {
          found = true;
          break;
        }
      }
    }
  }
  out[row] = found;
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Inserts the valid rows of (spaces [n] int32, keys [n, 8] uint32) into
// the table (tkey [cap, 8], tspace [cap], cap a power of two) in place
// and adds the number of keys newly landed to *n_new. Returns the CUDA
// error code of the launch (0 = cudaSuccess).
extern "C" int hashindex_insert_launch(void* tkey, void* tspace, int64_t cap,
                                       const void* keys, const void* spaces,
                                       const void* valid, int64_t n,
                                       void* n_new, void* stream) {
  if (n <= 0) return 0;
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
