// Fused fleet LWW merge for Hopper (sm_90a).
//
// Replaces the TPU kernel automerge_tpu/fleet/pallas_merge.py
// (_pallas_apply_op_batch_impl -> _merge_kernel / _merge_kernel_loop):
// per (doc, key) cell of the [N, K+1] int32 grids,
//   winners  = max(old winner, packed ids of the valid set lanes),
//   values   = value of the lane whose packed id is the new winner
//              (duplicate packed ids carry equal values),
//   counters = sum of the valid inc deltas, plus the old counter only
//              where the winner did not change,
// and stats += number of valid lanes. Column K is the scratch column of
// the grids; a valid lane whose key lies outside [0, K] is dropped, as
// XLA's scatter drops out-of-bounds updates.
//
// Design. The Pallas kernel tiles docs x keys x op chunks into VMEM
// one-hot blocks because Mosaic cannot scatter; on Hopper the merge is a
// scatter into device memory, so the one-hot tiles have no place here.
// One CTA owns one doc row: its threads stride over that doc's P op
// lanes, and the row's phases are separated by __syncthreads(). No other
// CTA touches the row, so no grid-wide synchronisation is needed:
//   0. fresh: zero the row of all three grids (the fused zero-fill of a
//      fresh fleet's first dispatch);
//   1. snapshot each set lane's pre-batch winner into old_w (not noinc);
//   2. atomicMax the set lanes' packed ids into winners;
//   3. set lanes equal to the new winner write their value; a set lane
//      whose cell's winner changed zeroes its counter (not noinc);
//   4. atomicAdd the inc lanes' deltas into counters (not noinc).
//
// Bound: bytes. Each op lane is read once (3 int32 + 3 bool) and each
// touched cell is read and written once per grid; the arithmetic is a
// handful of integer ops per lane, far below the card's rates. The
// design reads each lane's columns with neighbouring threads on
// neighbouring addresses and touches only the cells the lanes name.
//
// Built by merge_kernel.py with nvcc into a shared library with a plain
// C interface (no PyTorch headers), loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
lww_merge_kernel(const int32_t* __restrict__ key_id,
                 const int32_t* __restrict__ packed,
                 const int32_t* __restrict__ value,
                 const uint8_t* __restrict__ is_set,
                 const uint8_t* __restrict__ is_inc,
                 const uint8_t* __restrict__ valid,
                 int32_t* __restrict__ winners,
                 int32_t* __restrict__ values,
                 int32_t* __restrict__ counters,
                 int32_t* __restrict__ old_w,
                 int32_t* __restrict__ stats,
                 int64_t n_lanes, int64_t n_cols, int noinc, int fresh) {
  const int64_t doc = blockIdx.x;
  const int64_t orow = doc * n_lanes;
  int32_t* w = winners + doc * n_cols;
  int32_t* v = values + doc * n_cols;
  int32_t* c = counters + doc * n_cols;

  if (fresh) {
    for (int64_t k = threadIdx.x; k < n_cols; k += kThreads) {
      w[k] = 0;
      v[k] = 0;
      c[k] = 0;
    }
    __syncthreads();
  }

  // Phase 1: count valid lanes; snapshot pre-batch winners of set lanes.
  int n_valid = 0;
  for (int64_t l = threadIdx.x; l < n_lanes; l += kThreads) {
    if (!valid[orow + l]) continue;
    ++n_valid;
    const int32_t k = key_id[orow + l];
    if (!noinc && is_set[orow + l] && k >= 0 && k < n_cols)
      old_w[orow + l] = w[k];
  }
  // one atomic per warp for the batch's lane count
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  if ((threadIdx.x & 31) == 0 && n_valid) atomicAdd(stats, n_valid);
  __syncthreads();

  // Phase 2: LWW winners by atomicMax of packed op ids.
  for (int64_t l = threadIdx.x; l < n_lanes; l += kThreads) {
    const int32_t k = key_id[orow + l];
    if (valid[orow + l] && is_set[orow + l] && k >= 0 && k < n_cols)
      atomicMax(&w[k], packed[orow + l]);
  }
  __syncthreads();

  // Phase 3: the winning lane's value; reset counters whose winner moved.
  for (int64_t l = threadIdx.x; l < n_lanes; l += kThreads) {
    const int32_t k = key_id[orow + l];
    if (!(valid[orow + l] && is_set[orow + l] && k >= 0 && k < n_cols))
      continue;
    const int32_t now = w[k];
    if (packed[orow + l] == now) v[k] = value[orow + l];
    if (!noinc && now != old_w[orow + l]) c[k] = 0;
  }
  if (noinc) return;
  __syncthreads();

  // Phase 4: counter increments.
  for (int64_t l = threadIdx.x; l < n_lanes; l += kThreads) {
    const int32_t k = key_id[orow + l];
    if (valid[orow + l] && is_inc[orow + l] && k >= 0 && k < n_cols)
      atomicAdd(&c[k], value[orow + l]);
  }
}

}  // namespace

// Launches the merge over n_docs rows on `stream`. Returns the CUDA
// error code of the launch (0 = cudaSuccess); the caller raises on
// anything else.
extern "C" int lww_merge_launch(const void* key_id, const void* packed,
                                const void* value, const void* is_set,
                                const void* is_inc, const void* valid,
                                void* winners, void* values, void* counters,
                                void* old_w, void* stats, int64_t n_docs,
                                int64_t n_lanes, int64_t n_cols, int noinc,
                                int fresh, void* stream) {
  if (n_docs <= 0) return 0;
  lww_merge_kernel<<<static_cast<unsigned int>(n_docs), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key_id), static_cast<const int32_t*>(packed),
      static_cast<const int32_t*>(value), static_cast<const uint8_t*>(is_set),
      static_cast<const uint8_t*>(is_inc), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(winners), static_cast<int32_t*>(values),
      static_cast<int32_t*>(counters), static_cast<int32_t*>(old_w),
      static_cast<int32_t*>(stats), n_lanes, n_cols, noinc, fresh);
  return static_cast<int>(cudaGetLastError());
}
