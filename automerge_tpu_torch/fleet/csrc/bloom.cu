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
// An invalid lane (padding, or past a row's entry count) reads and writes
// nothing.
//
// What bounds them on this card. A sync round's build carries ~1M lanes
// (100k links x 8 hashes, pow2-padded), 800k of them valid: a 1 B valid
// flag per lane, 12 B of words per valid lane, two int64s per live row
// and a 1 MB output, so ~13 MB of device traffic, 4 us at 3.35 TB/s.
// Each valid lane also issues 7 scattered atomicOr's into the output,
// which stays resident in the 50 MB L2, so the build is bound by the L2's
// atomic rate as much as by bytes. The probe reads the same words and
// gathers 7 bytes per lane from the flat filters (L2-resident too).
//
// What the design does about it. One thread per lane, neighbouring threads
// on neighbouring lanes, so the word and flag loads coalesce. The build
// sets bits with atomicOr on a uint32 view of the packed output: LSB-first
// bytes are the little-endian bit order of uint32 words, and the flat
// length is a power of two >= 64 bits (bloom.py pads it), so the view is
// exact and no separate bit-packing pass exists. The wrapper
// (sync_kernels.bloom_build) allocates the output zeroed. The probe does
// its 7 byte gathers and stops at the first clear bit.
//
// Built by cuda_build.py with nvcc into a shared library with a plain C
// interface (no PyTorch headers), bound with ctypes in sync_kernels.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProbes = 7;
constexpr int kThreads = 256;

__global__ void bloom_build_kernel(const uint32_t* __restrict__ words,
                                   const uint8_t* __restrict__ valid,
                                   const int64_t* __restrict__ row_bits,
                                   const int64_t* __restrict__ bit_off,
                                   uint32_t* __restrict__ out, int64_t lanes,
                                   int64_t per_row) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (lane >= lanes || !valid[lane]) return;
  const int64_t row = lane / per_row;
  const uint32_t m = static_cast<uint32_t>(row_bits[row]);
  const int64_t off = bit_off[row];
  const uint32_t* w = words + lane * 3;
  uint32_t x = w[0] % m, y = w[1] % m;
  const uint32_t z = w[2] % m;
  for (int p = 0; p < kProbes; ++p) {
    if (p) {
      x = (x + y) % m;
      y = (y + z) % m;
    }
    const int64_t bit = off + x;
    atomicOr(out + (bit >> 5), 1u << (bit & 31));
  }
}

__global__ void bloom_probe_kernel(const uint8_t* __restrict__ flat,
                                   const int64_t* __restrict__ row_bits,
                                   const int64_t* __restrict__ byte_off,
                                   const uint32_t* __restrict__ words,
                                   const uint8_t* __restrict__ valid,
                                   uint8_t* __restrict__ out, int64_t lanes,
                                   int64_t per_row) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (lane >= lanes) return;
  bool hit = valid[lane] != 0;
  if (hit) {
    const int64_t row = lane / per_row;
    const uint32_t m = static_cast<uint32_t>(row_bits[row]);
    const uint8_t* filter = flat + byte_off[row];
    const uint32_t* w = words + lane * 3;
    uint32_t x = w[0] % m, y = w[1] % m;
    const uint32_t z = w[2] % m;
    for (int p = 0; p < kProbes && hit; ++p) {
      if (p) {
        x = (x + y) % m;
        y = (y + z) % m;
      }
      hit = (filter[x >> 3] >> (x & 7)) & 1;
    }
  }
  out[lane] = hit;
}

unsigned int blocks_for(int64_t lanes) {
  return static_cast<unsigned int>((lanes + kThreads - 1) / kThreads);
}

}  // namespace

// Sets the 7 probe bits of every valid lane of `words` ([rows, per_row, 3]
// uint32) in `out`, the zeroed flat filter viewed as uint32 words.
// Returns the CUDA error code of the launch (0 = cudaSuccess).
extern "C" int bloom_build_launch(const void* words, const void* valid,
                                  const void* row_bits, const void* bit_off,
                                  void* out, int64_t rows, int64_t per_row,
                                  void* stream) {
  const int64_t lanes = rows * per_row;
  if (lanes <= 0) return 0;
  bloom_build_kernel<<<blocks_for(lanes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(row_bits),
      static_cast<const int64_t*>(bit_off), static_cast<uint32_t*>(out),
      lanes, per_row);
  return static_cast<int>(cudaGetLastError());
}

// out[lane] = all 7 probe bits of the lane set in its row's filter, and
// the lane valid ([rows, per_row] bool). Returns the CUDA error code.
extern "C" int bloom_probe_launch(const void* flat, const void* row_bits,
                                  const void* byte_off, const void* words,
                                  const void* valid, void* out, int64_t rows,
                                  int64_t per_row, void* stream) {
  const int64_t lanes = rows * per_row;
  if (lanes <= 0) return 0;
  bloom_probe_kernel<<<blocks_for(lanes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), static_cast<const int64_t*>(row_bits),
      static_cast<const int64_t*>(byte_off),
      static_cast<const uint32_t*>(words), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(out), lanes, per_row);
  return static_cast<int>(cudaGetLastError());
}
