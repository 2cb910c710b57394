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
// XLA's scatter drops out-of-bounds updates. Counter sums wrap mod 2^32.
//
// The Pallas kernel tiles docs x keys x op chunks into VMEM one-hot
// blocks because Mosaic cannot scatter; on Hopper the merge is a scatter,
// so the tiles have no place here. No two CTAs touch the same cells, so
// no route needs grid-wide synchronisation or atomics on grid cells.
// merge_kernel.py's _launch_plan picks one route per launch:
//
// warp (in place, P <= 32). Bound: latency, then the scattered cell
//   accesses. A doc's work is a few hundred bytes scattered over 4 KB
//   rows, so a doc costs its chain of dependent device-memory round
//   trips, and each 4-byte cell access moves a whole 32-byte sector. One
//   warp owns one doc (a CTA holds blockDim/32 docs): lane l loads op
//   lane l, coalesced; __match_any_sync groups the lanes by key;
//   full-warp shuffles over the P lanes reduce each group (max packed id
//   over its set lanes with that lane's value, sum of its inc deltas);
//   the group's lowest lane reads the old winner and counter and writes
//   the cell once. Two round trips per doc, no barrier between phases,
//   no old-winner scratch array.
//
// cta (in place, P > 32). Same bound. One CTA owns one doc and walks its
//   lanes in four phases separated by __syncthreads(): snapshot the old
//   winner of each set lane into old_w, atomicMax the winners, write the
//   winning value and reset counters whose winner moved, atomicAdd the
//   incs. Kept for wide batches, where a doc's lanes fill the CTA.
//
// fresh (a fresh fleet's first batch, any P). Bound: bytes -- every cell
//   of the three grids is written once. A CTA owns a contiguous flat
//   range of cells (D whole rows, or one key chunk of a row too wide for
//   the shared-memory budget), builds it in shared memory (zero, shared
//   atomicMax / atomicAdd, then the winning values), and writes each
//   grid's range with 16-byte streaming stores over its aligned interior
//   and scalar stores at its two ends. Each grid's shared copy is placed
//   at the same offset mod 16 B as its global range, so the vector copy
//   is aligned on both sides. A thread's first lane is loaded before the
//   zero-fill, hiding that round trip. Small tiles (D = 2 rows at the
//   seam's width) keep many CTAs per SM, so one CTA's lane phase
//   overlaps another's stores. In a fresh grid the old winner and
//   counter are 0, so no snapshot is needed. merge_kernel.py's
//   _fresh_tile spells out the tile of each CTA that the kernel computes
//   from blockIdx.
//
// Every route counts valid lanes per CTA and adds them to stats with one
// atomic. Built by merge_kernel.py with nvcc into a shared library with a
// plain C interface (no PyTorch headers), loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxThreads = 256;

// Adds the CTA's valid-lane count to *stats with one atomic. Every thread
// of the CTA must call it (it holds a __syncthreads()).
__device__ void add_block_count(int n, int32_t* stats) {
  __shared__ int counts[kMaxThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  n = __reduce_add_sync(kAll, n);
  if (lane == 0) counts[warp] = n;
  __syncthreads();
  if (warp == 0) {
    int total = lane < static_cast<int>(blockDim.x >> 5) ? counts[lane] : 0;
    total = __reduce_add_sync(kAll, total);
    if (lane == 0 && total) atomicAdd(stats, total);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lww_merge_warp(const int32_t* __restrict__ key_id,
               const int32_t* __restrict__ packed,
               const int32_t* __restrict__ value,
               const uint8_t* __restrict__ is_set,
               const uint8_t* __restrict__ is_inc,
               const uint8_t* __restrict__ valid,
               int32_t* __restrict__ winners,
               int32_t* __restrict__ values,
               int32_t* __restrict__ counters,
               int32_t* __restrict__ stats,
               int64_t n_docs, int n_lanes, int64_t n_cols, int noinc) {
  const int lane = threadIdx.x & 31;
  const int64_t doc =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  int n_valid = 0;
  if (doc < n_docs) {  // uniform across the warp
    bool vd = false, st = false, ic = false;
    int32_t k = -1, pk = 0, val = 0;
    if (lane < n_lanes) {
      const int64_t o = doc * n_lanes + lane;
      vd = valid[o];
      st = is_set[o];
      ic = is_inc[o];
      k = key_id[o];
      pk = packed[o];
      val = value[o];
    }
    n_valid = vd;
    const bool in_range = vd && k >= 0 && k < n_cols;
    const bool set = in_range && st;
    const bool inc = in_range && ic && !noinc;
    const unsigned set_bits = __ballot_sync(kAll, set);
    const unsigned inc_bits = __ballot_sync(kAll, inc);
    // lanes that touch no cell share the sentinel key -1
    const bool mine = set || inc;
    const unsigned peers = __match_any_sync(kAll, mine ? k : -1);

    // Per key group: the highest packed id among its set lanes with that
    // lane's value, and the sum of its inc deltas. Every lane takes part
    // in every shuffle; each keeps only its own group's lanes.
    bool have = false;
    int32_t gmax = 0, gval = 0;
    uint32_t isum = 0;
    for (int i = 0; i < n_lanes; ++i) {
      const int32_t p_i = __shfl_sync(kAll, pk, i);
      const int32_t v_i = __shfl_sync(kAll, val, i);
      if (!((peers >> i) & 1u)) continue;
      if (((set_bits >> i) & 1u) && (!have || p_i > gmax)) {
        have = true;
        gmax = p_i;
        gval = v_i;
      }
      if ((inc_bits >> i) & 1u) isum += static_cast<uint32_t>(v_i);
    }

    if (mine && lane == __ffs(peers) - 1) {  // one writer per cell
      const int64_t cell = doc * n_cols + k;
      if (!have) {  // inc lanes only: the winner stands, the incs add
        counters[cell] =
            static_cast<int32_t>(static_cast<uint32_t>(counters[cell]) + isum);
      } else {
        const int32_t old_w = winners[cell];
        const int32_t old_c = noinc ? 0 : counters[cell];
        const int32_t new_w = old_w > gmax ? old_w : gmax;
        if (new_w != old_w) winners[cell] = new_w;
        if (gmax == new_w) values[cell] = gval;
        if (!noinc) {
          const uint32_t base =
              new_w != old_w ? 0u : static_cast<uint32_t>(old_c);
          const int32_t new_c = static_cast<int32_t>(base + isum);
          if (new_c != old_c) counters[cell] = new_c;
        }
      }
    }
  }
  add_block_count(n_valid, stats);
}

__global__ void __launch_bounds__(kMaxThreads)
lww_merge_cta(const int32_t* __restrict__ key_id,
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
              int64_t n_lanes, int64_t n_cols, int noinc) {
  const int64_t doc = blockIdx.x;
  const int64_t orow = doc * n_lanes;
  int32_t* w = winners + doc * n_cols;
  int32_t* v = values + doc * n_cols;
  int32_t* c = counters + doc * n_cols;

  // Phase 1: count valid lanes; snapshot pre-batch winners of set lanes.
  int n_valid = 0;
  for (int64_t l = threadIdx.x; l < n_lanes; l += blockDim.x) {
    if (!valid[orow + l]) continue;
    ++n_valid;
    const int32_t k = key_id[orow + l];
    if (!noinc && is_set[orow + l] && k >= 0 && k < n_cols)
      old_w[orow + l] = w[k];
  }
  add_block_count(n_valid, stats);  // also the barrier after phase 1

  // Phase 2: LWW winners by atomicMax of packed op ids.
  for (int64_t l = threadIdx.x; l < n_lanes; l += blockDim.x) {
    const int32_t k = key_id[orow + l];
    if (valid[orow + l] && is_set[orow + l] && k >= 0 && k < n_cols)
      atomicMax(&w[k], packed[orow + l]);
  }
  __syncthreads();

  // Phase 3: the winning lane's value; reset counters whose winner moved.
  for (int64_t l = threadIdx.x; l < n_lanes; l += blockDim.x) {
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
  for (int64_t l = threadIdx.x; l < n_lanes; l += blockDim.x) {
    const int32_t k = key_id[orow + l];
    if (valid[orow + l] && is_inc[orow + l] && k >= 0 && k < n_cols)
      atomicAdd(&c[k], value[orow + l]);
  }
}

// Writes src[0, n) to dst[0, n): 16-byte streaming stores (evict-first:
// nothing reads the grid again in this launch) over the interior where
// dst is 16-byte aligned, scalar stores at the two ends. src must share
// dst's alignment mod 16 bytes.
__device__ void store_range(int32_t* __restrict__ dst,
                            const int32_t* __restrict__ src, int64_t n) {
  const int64_t head_max =
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  const int64_t head = head_max < n ? head_max : n;
  const int64_t n4 = (n - head) >> 2;
  const int64_t tail = head + 4 * n4;
  if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  int4* dst4 = reinterpret_cast<int4*>(dst + head);
  const int4* src4 = reinterpret_cast<const int4*>(src + head);
  for (int64_t i = threadIdx.x; i < n4; i += blockDim.x)
    __stcs(dst4 + i, src4[i]);
  if (tail + threadIdx.x < n) dst[tail + threadIdx.x] = src[tail + threadIdx.x];
}

// One op lane, all six columns loaded at once.
struct Lane {
  int32_t key, packed, value;
  bool set, inc, valid;
};

__device__ Lane load_lane(const int32_t* __restrict__ key_id,
                          const int32_t* __restrict__ packed,
                          const int32_t* __restrict__ value,
                          const uint8_t* __restrict__ is_set,
                          const uint8_t* __restrict__ is_inc,
                          const uint8_t* __restrict__ valid, int64_t l) {
  return {key_id[l], packed[l], value[l], is_set[l] != 0, is_inc[l] != 0,
          valid[l] != 0};
}

__global__ void __launch_bounds__(kMaxThreads)
lww_merge_fresh(const int32_t* __restrict__ key_id,
                const int32_t* __restrict__ packed,
                const int32_t* __restrict__ value,
                const uint8_t* __restrict__ is_set,
                const uint8_t* __restrict__ is_inc,
                const uint8_t* __restrict__ valid,
                int32_t* __restrict__ winners,
                int32_t* __restrict__ values,
                int32_t* __restrict__ counters,
                int32_t* __restrict__ stats,
                int64_t n_docs, int64_t n_lanes, int64_t n_cols, int noinc,
                int64_t docs_per_cta, int64_t key_chunk,
                int64_t smem_cells) {
  extern __shared__ int4 smem4[];
  const int64_t n_chunks = (n_cols + key_chunk - 1) / key_chunk;
  const int64_t d0 = (blockIdx.x / n_chunks) * docs_per_cta;
  const int64_t d1 = d0 + docs_per_cta < n_docs ? d0 + docs_per_cta : n_docs;
  const int64_t c0 = (blockIdx.x % n_chunks) * key_chunk;
  const int64_t c1 = c0 + key_chunk < n_cols ? c0 + key_chunk : n_cols;
  // The CTA's cells: docs [d0, d1) x keys [c0, c1), which is one flat
  // range because either d1 - d0 == 1 or [c0, c1) is the whole row.
  const int64_t f0 = d0 * n_cols + c0;
  const int64_t n_cells = (d1 - 1) * n_cols + c1 - f0;

  int32_t* const grid[3] = {winners + f0, values + f0, counters + f0};
  int32_t* sh[3];
#pragma unroll
  for (int g = 0; g < 3; ++g)
    sh[g] = reinterpret_cast<int32_t*>(smem4) + g * smem_cells +
            ((reinterpret_cast<uintptr_t>(grid[g]) >> 2) & 3);

  // This thread's first lane is loaded before the zero-fill, so its
  // device-memory round trip overlaps the fill; later strides (more lanes
  // than threads) load in the loops below.
  const int64_t lf = d0 * n_lanes + threadIdx.x, l1 = d1 * n_lanes;
  Lane first{};
  if (lf < l1)
    first = load_lane(key_id, packed, value, is_set, is_inc, valid, lf);

  for (int64_t i = threadIdx.x; i < 3 * smem_cells / 4; i += blockDim.x)
    smem4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // Winners and counters: shared atomics of the lanes that land here.
  int n_valid = 0;
  for (int64_t l = lf; l < l1; l += blockDim.x) {
    const Lane a = l == lf ? first : load_lane(key_id, packed, value,
                                               is_set, is_inc, valid, l);
    if (!a.valid) continue;
    ++n_valid;
    if (a.key < c0 || a.key >= c1) continue;
    const int64_t j = (l / n_lanes) * n_cols + a.key - f0;
    if (a.set) atomicMax(&sh[0][j], a.packed);
    if (!noinc && a.inc) atomicAdd(&sh[2][j], a.value);
  }
  // lanes are counted by the CTA of a row's first key chunk only
  add_block_count(c0 == 0 ? n_valid : 0, stats);  // also the barrier

  // Values: the lanes that hold their cell's winner.
  for (int64_t l = lf; l < l1; l += blockDim.x) {
    const Lane a = l == lf ? first : load_lane(key_id, packed, value,
                                               is_set, is_inc, valid, l);
    if (!(a.valid && a.set) || a.key < c0 || a.key >= c1) continue;
    const int64_t j = (l / n_lanes) * n_cols + a.key - f0;
    if (a.packed == sh[0][j]) sh[1][j] = a.value;
  }
  __syncthreads();

#pragma unroll
  for (int g = 0; g < 3; ++g) store_range(grid[g], sh[g], n_cells);
}

}  // namespace

// Sets the fresh kernel's shared-memory attributes on the current device:
// up to max_smem_bytes of dynamic shared memory per CTA (above the 48 KB
// default this must be asked for), and the largest shared-memory carveout.
// merge_kernel.py calls it once per device, before the first fresh launch
// there. Returns the CUDA error code (0 = cudaSuccess).
extern "C" int lww_merge_setup(int max_smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      lww_merge_fresh, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lww_merge_fresh,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

// Launches the merge on `stream` along the plan merge_kernel.py computed:
// route 0 = warp, 1 = cta, 2 = fresh; `grid` CTAs of `threads` threads.
// The warp route takes threads / 32 docs per CTA; the fresh route reads
// its tile (docs_per_cta, key_chunk) and 3 x smem_cells int32 cells of
// dynamic shared memory, which the other routes ignore. old_w is the cta
// route's [N, P] scratch (null with noinc). Returns the CUDA error code
// of the launch (0 = cudaSuccess); the caller raises on anything else.
extern "C" int lww_merge_launch(const void* key_id, const void* packed,
                                const void* value, const void* is_set,
                                const void* is_inc, const void* valid,
                                void* winners, void* values, void* counters,
                                void* old_w, void* stats, int64_t n_docs,
                                int64_t n_lanes, int64_t n_cols, int noinc,
                                int route, int64_t grid, int threads,
                                int64_t docs_per_cta, int64_t key_chunk,
                                int64_t smem_cells, void* stream) {
  if (grid <= 0) return 0;
  const auto k = static_cast<const int32_t*>(key_id);
  const auto p = static_cast<const int32_t*>(packed);
  const auto v = static_cast<const int32_t*>(value);
  const auto s = static_cast<const uint8_t*>(is_set);
  const auto i = static_cast<const uint8_t*>(is_inc);
  const auto ok = static_cast<const uint8_t*>(valid);
  const auto w = static_cast<int32_t*>(winners);
  const auto vs = static_cast<int32_t*>(values);
  const auto c = static_cast<int32_t*>(counters);
  const auto st = static_cast<int32_t*>(stats);
  const auto strm = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned int>(grid);
  switch (route) {
    case 0:
      lww_merge_warp<<<blocks, threads, 0, strm>>>(
          k, p, v, s, i, ok, w, vs, c, st, n_docs,
          static_cast<int>(n_lanes), n_cols, noinc);
      break;
    case 1:
      lww_merge_cta<<<blocks, threads, 0, strm>>>(
          k, p, v, s, i, ok, w, vs, c, static_cast<int32_t*>(old_w), st,
          n_lanes, n_cols, noinc);
      break;
    case 2:
      lww_merge_fresh<<<blocks, threads,
                        static_cast<size_t>(3 * smem_cells) * sizeof(int32_t),
                        strm>>>(k, p, v, s, i, ok, w, vs, c, st, n_docs,
                                n_lanes, n_cols, noinc, docs_per_cta,
                                key_chunk, smem_cells);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
