// Batched Bloom-filter build and probe over the flat packed layout, for
// Hopper (sm_90a).
//
// Replaces two jax.jit kernels of automerge_tpu/fleet/bloom.py:
//   bloom_build  <- _build_flat_packed (:187)
//   bloom_probe  <- _probe_flat_packed (:201)
// Filter r of a batch owns bits [bit_off[r], bit_off[r] + row_bits[r]) of
// one flat bit vector, packed LSB-first into bytes (the sync wire format,
// ref backend/sync.js:38-125). Lane (r, j) is hash j of row r: its first
// three little-endian uint32 words x, y, z give 7 probes by triple
// hashing, mod m = row_bits[r], iterated in uint32 as bloom.py's
// _probe_indexes does (:75-89):
//   p0 = x % m;  p(i+1) = (p(i) + y) % m, y = (y + z) % m.
// An invalid lane (padding, or past a row's entry count) sets or tests
// nothing.
//
// What bounds them on this card. A sync round's build carries ~1M lanes
// (100k links x 8 hashes, pow2-padded), 800k of them valid: a 1 B valid
// flag per lane, 12 B of words per valid lane, two int64s per live row
// and a 1 MB output, so ~13 MB of device traffic, 4 us at 3.35 TB/s, and
// ~22 integer operations per valid lane. At that size the build is a
// chain of a few dependent steps per CTA (its rows and lanes, the bits,
// the stores) more than it is bytes: the CTAs are on the card at once, so
// the kernel takes about one CTA's chain.
//
// The build: CTAs own groups of rows and each stores its output bytes
// once, so the output needs no memset (the wrapper allocates it with
// torch.empty) and no global atomic is issued. Rows are whole bytes, laid
// out in bit_off order without overlap, with padded rows at the output's
// end (bloom.flat_build_lanes). CTA c owns `group` consecutive rows
// (1,024 lanes / H of them, at most 256; sync_kernels.bloom_plan) and the
// bytes from its first row's start (0 for the first CTA) to the next
// group's first row's start (the output's end for the last): its rows
// whole, so no row is cut between CTAs, and the CTAs' bytes cover the
// output once (sync_kernels.bloom_groups_plain is the same rule in torch
// ops). One round trip brings the group's rows into shared memory, its
// bytes' ends and its lanes' first batch (4 lanes a thread: their flags
// and words, the words of invalid lanes too), while the threads zero the
// window. The CTA sets its rows' probe bits with shared-memory atomicOr
// in the window, a copy of its bytes, then writes the window out (16-byte
// stores, single bytes at its two edges); the bytes past its last live
// row (the zero tail, in the CTA of the last row) are written as zeros
// directly. The window holds the group's rows
// at the longest the batch's hash axis admits, up to WINDOW_CAP bytes of
// shared memory: a row up to WINDOW_CAP - 16 bytes (163,827 entries) is
// built in one pass over its lanes; a longer one takes a pass per window.
// H is a power of two, so a lane's row is a shift. A modulo is two
// multiplications by the row's 64-bit reciprocal (fast_mod), computed
// once per row. After the three first moduli, each step (x + y) % m with
// x, y < m is x + y - m where x + y >= m: exact while m <= 2^31; a row
// with m > 2^31 keeps the uint32 modulo chain (x + y wraps first there;
// sync_kernels.probe_indexes_stepped is the rule in torch ops). In the
// usual single pass every probe lands in the window, so its bit needs no
// range check and takes 32-bit arithmetic.
//
// The probe: one thread per lane, neighbouring threads on neighbouring
// lanes, so the flag and word loads coalesce. At the sync path's shape
// (16,384 rows x 16 lanes, 90,000 valid, over 131 KB of filters) its
// 1.9 MB take 0.6 us at 3.35 TB/s; what it pays is a launch, the
// instructions of 262,144 threads in one wave, and the chain of dependent
// round trips a thread waits on. So a thread makes two round trips. The
// first brings its flag, its three words and its row's capacity and
// offset together: the row is a shift of the lane (bloom.py pads the hash
// axis to a power of two; another H divides), so no load waits on an
// earlier one. The second is the 7 byte gathers, issued together: the
// positions come first, and a valid lane's positions all lie inside its
// row, so no gather waits on another's bit. The positions take the three
// first moduli by the uint32 %, then the build's x + y - m step while
// m <= 2^31 (the uint32 modulo chain above): the build's 64-bit
// reciprocal costs one 64-bit division per row, which a thread per lane
// would pay on its own chain (measured slower than the % here, even
// computed once per row in shared memory behind a barrier). Indices are
// 32-bit where the lanes' words fit. An invalid lane (and a lane of an
// empty row) gathers nothing and answers false.
//
// Built by cuda_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers), bound with ctypes in sync_kernels.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProbes = 7;
constexpr int kThreads = 256;
constexpr int kBatch = 4;     // lanes a thread loads at once
constexpr uint32_t kHalf = 0x80000000u;   // 2^31

// x % m for a 32-bit x, exact for every m >= 1, with mul = ~0 / m + 1
// (Lemire, Kaser and Kurz, "Faster remainder by direct computation",
// 2019): two multiplications where a 32-bit % is a few dozen instructions.
__device__ __forceinline__ uint32_t fast_mod(uint32_t x, uint64_t mul,
                                             uint32_t m) {
  return static_cast<uint32_t>(__umul64hi(mul * x, m));
}

// The 7 probe positions of one lane, relative to its row's first bit,
// handed to `set(p)`: x % m, then (x + y) % m and y = (y + z) % m six
// times, in uint32 (bloom.py _probe_indexes).
template <class Set>
__device__ __forceinline__ void for_probes(uint32_t x, uint32_t y,
                                           uint32_t z, uint32_t m,
                                           uint64_t mul, Set set) {
  x = fast_mod(x, mul, m);
  y = fast_mod(y, mul, m);
  z = fast_mod(z, mul, m);
  set(x);
  if (m <= kHalf) {
#pragma unroll
    for (int p = 1; p < kProbes; ++p) {
      x += y;
      x -= x >= m ? m : 0;
      y += z;
      y -= y >= m ? m : 0;
      set(x);
    }
  } else {
    for (int p = 1; p < kProbes; ++p) {
      x = fast_mod(x + y, mul, m);
      y = fast_mod(y + z, mul, m);
      set(x);
    }
  }
}

// Bytes [lo, hi) of `out`: from the window (whose byte 0 is `base`, a
// multiple of 16), or zeros without one. 16-byte stores where a whole
// aligned chunk is inside, single bytes at the two edges.
__device__ __forceinline__ void store_span(uint8_t* out, int64_t lo,
                                           int64_t hi, const uint4* win,
                                           int64_t base) {
  const uint8_t* win_bytes = reinterpret_cast<const uint8_t*>(win);
  for (int64_t at = (lo & ~static_cast<int64_t>(15)) + 16 * threadIdx.x;
       at < hi; at += 16 * static_cast<int64_t>(blockDim.x)) {
    if (at >= lo && at + 16 <= hi) {
      reinterpret_cast<uint4*>(out)[at >> 4] =
          win ? win[(at - base) >> 4] : make_uint4(0, 0, 0, 0);
    } else {
      for (int i = 0; i < 16; ++i)
        if (at + i >= lo && at + i < hi)
          out[at + i] = win ? win_bytes[at + i - base] : 0;
    }
  }
}

// kBatch lanes of a thread, kThreads apart from `first`: their flags and
// words, loaded together (the words of invalid lanes too, so one round
// trip serves the batch).
struct Batch {
  uint32_t x[kBatch], y[kBatch], z[kBatch];
  unsigned live = 0;

  __device__ __forceinline__ void load(const uint32_t* words,
                                       const uint8_t* valid, int64_t first,
                                       int64_t end) {
    live = 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t lane = first + i * static_cast<int64_t>(kThreads);
      if (lane >= end) continue;
      live |= static_cast<unsigned>(valid[lane] != 0) << i;
      x[i] = words[lane * 3];
      y[i] = words[lane * 3 + 1];
      z[i] = words[lane * 3 + 2];
    }
  }
};

__global__ void __launch_bounds__(kThreads)
bloom_build_kernel(const uint32_t* __restrict__ words,
                   const uint8_t* __restrict__ valid,
                   const int64_t* __restrict__ row_bits,
                   const int64_t* __restrict__ bit_off,
                   uint8_t* __restrict__ out, int64_t rows, int log_h,
                   int64_t group, int64_t total, int64_t window) {
  extern __shared__ uint4 win[];
  __shared__ int64_t s_off[kThreads];
  __shared__ uint64_t s_mul[kThreads];
  __shared__ uint32_t s_bits[kThreads];
  const int t = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * group;
  const int64_t r1 = min(rows, r0 + group);
  // the group's rows (to shared memory), its bytes, and its lanes' first
  // batch, all in one round trip
  bool live = false;
  if (t < r1 - r0) {
    s_off[t] = bit_off[r0 + t];
    s_bits[t] = static_cast<uint32_t>(row_bits[r0 + t]);
    s_mul[t] = s_bits[t] ? ~0ull / s_bits[t] + 1 : 0;
    live = (s_off[t] >> 3) < total;
  }
  const int64_t own_lo = r0 == 0 ? 0 : min(bit_off[r0] >> 3, total);
  const int64_t own_hi = r1 < rows ? min(bit_off[r1] >> 3, total) : total;
  const int64_t lane_lo = r0 << log_h, lane_hi = r1 << log_h;
  Batch batch;
  batch.load(words, valid, lane_lo + t, lane_hi);
  for (int64_t c = t; c < window >> 4; c += kThreads)
    win[c] = make_uint4(0, 0, 0, 0);
  // rows start in order and padded ones past the output, so the live rows
  // are the group's first n_live
  const int n_live = __syncthreads_count(live);
  const int64_t rows_end =
      n_live ? (s_off[n_live - 1] + s_bits[n_live - 1]) >> 3 : own_lo;
  for (int64_t lo = own_lo; lo < rows_end;) {
    const int64_t base = lo & ~static_cast<int64_t>(15);
    const int64_t hi = min(rows_end, base + window);
    if (lo != own_lo) {
      for (int64_t c = t; c < (hi - base + 15) >> 4; c += kThreads)
        win[c] = make_uint4(0, 0, 0, 0);
      __syncthreads();
    }
    const int64_t lo_bit = lo * 8, hi_bit = hi * 8, base_bit = base * 8;
    uint32_t* bits = reinterpret_cast<uint32_t*>(win);
    // one pass over all the group's bytes: every probe of a live row lands
    // in the window, at a 32-bit offset from its start
    const bool whole = lo == own_lo && hi == rows_end;
    int64_t first = lane_lo + t;
    if (lo != own_lo) batch.load(words, valid, first, lane_hi);
    for (;;) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int64_t lane = first + i * static_cast<int64_t>(kThreads);
        const int64_t r = (lane >> log_h) - r0;
        if (!(batch.live >> i & 1) || r >= n_live) continue;
        const int64_t off = s_off[r];
        if (whole) {
          const uint32_t rel = static_cast<uint32_t>(off - base_bit);
          for_probes(batch.x[i], batch.y[i], batch.z[i], s_bits[r],
                     s_mul[r], [&](uint32_t p) {
                       atomicOr(bits + ((rel + p) >> 5),
                                1u << ((rel + p) & 31));
                     });
        } else {
          for_probes(batch.x[i], batch.y[i], batch.z[i], s_bits[r],
                     s_mul[r], [&](uint32_t p) {
                       const int64_t bit = off + p;
                       if (bit >= lo_bit && bit < hi_bit)
                         atomicOr(bits + ((bit - base_bit) >> 5),
                                  1u << (bit & 31));
                     });
        }
      }
      first += kBatch * static_cast<int64_t>(kThreads);
      if (first - t >= lane_hi) break;
      batch.load(words, valid, first, lane_hi);
    }
    __syncthreads();
    store_span(out, lo, hi, win, base);
    __syncthreads();
    lo = hi;
  }
  store_span(out, max(own_lo, rows_end), own_hi, nullptr, 0);
}

// The 7 probe positions of one lane, relative to its row's first bit, into
// registers: the three first moduli by the uint32 %, then x + y - m where
// x + y >= m while m <= 2^31, else the uint32 modulo chain (x + y wraps
// first there), as for_probes does with its reciprocal.
__device__ __forceinline__ void probe_positions(uint32_t x, uint32_t y,
                                                uint32_t z, uint32_t m,
                                                uint32_t (&pos)[kProbes]) {
  x %= m;
  y %= m;
  z %= m;
  pos[0] = x;
  if (m <= kHalf) {
#pragma unroll
    for (int p = 1; p < kProbes; ++p) {
      x += y;
      x -= x >= m ? m : 0;
      y += z;
      y -= y >= m ? m : 0;
      pos[p] = x;
    }
  } else {
#pragma unroll
    for (int p = 1; p < kProbes; ++p) {
      x = (x + y) % m;
      y = (y + z) % m;
      pos[p] = x;
    }
  }
}

// Idx is int32_t where every lane's word index fits (3 x lanes < 2^31),
// which saves the 64-bit index arithmetic, else int64_t.
template <class Idx>
__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const uint8_t* __restrict__ flat,
                   const int64_t* __restrict__ row_bits,
                   const int64_t* __restrict__ byte_off,
                   const uint32_t* __restrict__ words,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ out, Idx lanes, Idx per_row,
                   int log_h) {
  const Idx lane = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  // round trip 1: the lane's flag and words, its row's capacity and offset
  const Idx row = log_h >= 0 ? lane >> log_h : lane / per_row;
  const bool live = valid[lane] != 0;
  const uint32_t x = words[lane * 3], y = words[lane * 3 + 1],
                 z = words[lane * 3 + 2];
  const uint32_t m = static_cast<uint32_t>(row_bits[row]);
  const uint8_t* filter = flat + byte_off[row];
  bool hit = false;
  if (live && m) {
    uint32_t pos[kProbes];
    probe_positions(x, y, z, m, pos);
    // round trip 2: the 7 gathers at once
    uint32_t bytes[kProbes];
#pragma unroll
    for (int p = 0; p < kProbes; ++p) bytes[p] = __ldg(filter + (pos[p] >> 3));
    uint32_t all = 1;
#pragma unroll
    for (int p = 0; p < kProbes; ++p) all &= bytes[p] >> (pos[p] & 7);
    hit = all & 1;
  }
  out[lane] = hit;
}

unsigned int blocks_for(int64_t lanes) {
  return static_cast<unsigned int>((lanes + kThreads - 1) / kThreads);
}

}  // namespace

// Writes the flat filter `out` ([total] bytes, 16-byte aligned) in full:
// the 7 probe bits of every valid lane of `words` ([rows, 2^log_h, 3]
// uint32) set, every other bit clear. Rows are whole bytes in bit_off
// order without overlap, padded rows at `total`; one CTA per `group` rows
// (at most kThreads), `window` bytes of shared memory each (a multiple of
// 16; see sync_kernels.bloom_plan). Returns the CUDA error code of the
// launch (0 = cudaSuccess).
extern "C" int bloom_build_launch(const void* words, const void* valid,
                                  const void* row_bits, const void* bit_off,
                                  void* out, int64_t rows, int log_h,
                                  int64_t group, int64_t total,
                                  int64_t window, void* stream) {
  if (total <= 0) return 0;
  if (group <= 0 || group > kThreads || window <= 0 || window % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (window > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bloom_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(window));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // an empty batch still writes the zeroed output
  const unsigned int ctas =
      static_cast<unsigned int>(rows > 0 ? (rows + group - 1) / group : 1);
  bloom_build_kernel<<<ctas, kThreads, static_cast<size_t>(window),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(row_bits),
      static_cast<const int64_t*>(bit_off), static_cast<uint8_t*>(out), rows,
      log_h, group, total, window);
  return static_cast<int>(cudaGetLastError());
}

// out[lane] = all 7 probe bits of the lane set in its row's filter, and
// the lane valid ([rows, per_row] bool). A power-of-two per_row finds a
// lane's row by a shift, another by a division. Returns the CUDA error
// code.
extern "C" int bloom_probe_launch(const void* flat, const void* row_bits,
                                  const void* byte_off, const void* words,
                                  const void* valid, void* out, int64_t rows,
                                  int64_t per_row, void* stream) {
  const int64_t lanes = rows * per_row;
  if (lanes <= 0) return 0;
  const int log_h =
      (per_row & (per_row - 1)) == 0 ? 63 - __builtin_clzll(per_row) : -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(flat);
  const auto* bits = static_cast<const int64_t*>(row_bits);
  const auto* offs = static_cast<const int64_t*>(byte_off);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<uint8_t*>(out);
  if (lanes * 3 < (int64_t{1} << 31))
    bloom_probe_kernel<int32_t><<<blocks_for(lanes), kThreads, 0, s>>>(
        f, bits, offs, w, v, o, static_cast<int32_t>(lanes),
        static_cast<int32_t>(per_row), log_h);
  else
    bloom_probe_kernel<int64_t><<<blocks_for(lanes), kThreads, 0, s>>>(
        f, bits, offs, w, v, o, lanes, per_row, log_h);
  return static_cast<int>(cudaGetLastError());
}
