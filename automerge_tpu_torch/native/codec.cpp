// Native codec kernels for automerge_tpu.
//
// The components the JS reference delegates to npm packages (SHA-256 via
// fast-sha256, DEFLATE via pako) plus its hand-rolled LEB128/RLE/delta/
// boolean column codecs (ref backend/encoding.js) are implemented here as
// first-class C++ host kernels (SURVEY.md section 2.9). Column decoders emit
// int64 value arrays + validity masks directly, so binary changes decode
// straight into the padded tensors the fleet engine consumes.
//
// Exposed as a plain C ABI consumed from Python via ctypes.

// Python.h must precede every standard header (it sets libc feature-test
// macros); it is optional — without CPython headers everything except the
// zero-copy list ingest entry still builds (platform-independent: not
// tied to the x86 SIMD guard below).
#if defined(__has_include)
#if __has_include(<Python.h>)
#define AM_HAVE_PYTHON 1
#include <Python.h>
#endif
#endif

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <zlib.h>
#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#include <cpuid.h>
#define AM_HAVE_X86 1
#endif

// memcpy with a null pointer is UB even when n == 0 (glibc declares both
// arguments nonnull, and UBSan's nonnull check fires), and an empty
// std::vector's data() is exactly such a null — which every *_fetch
// entry hits when a hostile batch parses to zero rows. All bulk copies
// funnel through this guard.
static inline void copy_bytes(void *dst, const void *src, size_t n) {
  if (n && dst && src) memcpy(dst, src, n);
}

extern "C" {

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4), compact single-shot implementation
// ---------------------------------------------------------------------------

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void sha256_block(uint32_t state[8], const uint8_t *p) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++) {
    w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
           (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
  }
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K256[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

#ifdef AM_HAVE_X86
// SHA-NI block loop (Intel SHA extensions; FIPS 180-4 schedule expressed
// through sha256msg1/msg2 + sha256rnds2). Function-level target attribute so
// the rest of the TU stays baseline; dispatched behind a cpuid check.
__attribute__((target("sha,sse4.1,ssse3")))
static void sha256_blocks_shani(uint32_t state[8], const uint8_t *data,
                                uint64_t nblocks) {
#define AM_K4(i)                                                            \
  _mm_set_epi32(int(K256[(i) + 3]), int(K256[(i) + 2]), int(K256[(i) + 1]), \
                int(K256[(i)]))
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i TMP = _mm_loadu_si128((const __m128i *)&state[0]);
  __m128i STATE1 = _mm_loadu_si128((const __m128i *)&state[4]);
  TMP = _mm_shuffle_epi32(TMP, 0xB1);
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);
  __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);

  while (nblocks--) {
    const __m128i ABEF_SAVE = STATE0;
    const __m128i CDGH_SAVE = STATE1;
    __m128i MSG, MSG0, MSG1, MSG2, MSG3;

    /* rounds 0-3 */
    MSG0 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(data + 0)), MASK);
    MSG = _mm_add_epi32(MSG0, AM_K4(0));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    /* rounds 4-7 */
    MSG1 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(data + 16)), MASK);
    MSG = _mm_add_epi32(MSG1, AM_K4(4));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

    /* rounds 8-11 */
    MSG2 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(data + 32)), MASK);
    MSG = _mm_add_epi32(MSG2, AM_K4(8));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

    /* rounds 12-15 */
    MSG3 = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)(data + 48)), MASK);
    MSG = _mm_add_epi32(MSG3, AM_K4(12));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
    MSG0 = _mm_add_epi32(MSG0, TMP);
    MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

#define AM_ROUND4(W0, W1, W2, W3, i, do_msg1)                   \
    MSG = _mm_add_epi32(W0, AM_K4(i));                          \
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);        \
    TMP = _mm_alignr_epi8(W0, W3, 4);                           \
    W1 = _mm_add_epi32(W1, TMP);                                \
    W1 = _mm_sha256msg2_epu32(W1, W0);                          \
    MSG = _mm_shuffle_epi32(MSG, 0x0E);                         \
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);        \
    if (do_msg1) W3 = _mm_sha256msg1_epu32(W3, W0);

    AM_ROUND4(MSG0, MSG1, MSG2, MSG3, 16, 1)   /* rounds 16-19 */
    AM_ROUND4(MSG1, MSG2, MSG3, MSG0, 20, 1)   /* rounds 20-23 */
    AM_ROUND4(MSG2, MSG3, MSG0, MSG1, 24, 1)   /* rounds 24-27 */
    AM_ROUND4(MSG3, MSG0, MSG1, MSG2, 28, 1)   /* rounds 28-31 */
    AM_ROUND4(MSG0, MSG1, MSG2, MSG3, 32, 1)   /* rounds 32-35 */
    AM_ROUND4(MSG1, MSG2, MSG3, MSG0, 36, 1)   /* rounds 36-39 */
    AM_ROUND4(MSG2, MSG3, MSG0, MSG1, 40, 1)   /* rounds 40-43 */
    AM_ROUND4(MSG3, MSG0, MSG1, MSG2, 44, 1)   /* rounds 44-47 */
    AM_ROUND4(MSG0, MSG1, MSG2, MSG3, 48, 1)   /* rounds 48-51 */
    AM_ROUND4(MSG1, MSG2, MSG3, MSG0, 52, 0)   /* rounds 52-55 */
    AM_ROUND4(MSG2, MSG3, MSG0, MSG1, 56, 0)   /* rounds 56-59 */
#undef AM_ROUND4

    /* rounds 60-63 */
    MSG = _mm_add_epi32(MSG3, AM_K4(60));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
    MSG = _mm_shuffle_epi32(MSG, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

    STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
    STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
    data += 64;
  }

  TMP = _mm_shuffle_epi32(STATE0, 0x1B);
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);
  _mm_storeu_si128((__m128i *)&state[0], STATE0);
  _mm_storeu_si128((__m128i *)&state[4], STATE1);
#undef AM_K4
}

// Raw cpuid instead of __builtin_cpu_supports("sha"): not every GCC in the
// field accepts "sha" as a builtin feature name (g++ 10 rejects it at
// compile time, taking the whole codec — and the turbo seam — down with it).
// SHA extensions: CPUID.(EAX=7,ECX=0):EBX bit 29; SSE4.1: CPUID.1:ECX bit
// 19; SSSE3: CPUID.1:ECX bit 9.
static bool have_shani() {
  static const bool v = [] {
    unsigned eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
    if (!(ebx & (1u << 29))) return false;
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
    return (ecx & (1u << 19)) != 0 && (ecx & (1u << 9)) != 0;
  }();
  return v;
}
#endif  // AM_HAVE_X86

static void sha256_blocks(uint32_t state[8], const uint8_t *data,
                          uint64_t nblocks) {
#ifdef AM_HAVE_X86
  if (have_shani()) {
    sha256_blocks_shani(state, data, nblocks);
    return;
  }
#endif
  for (uint64_t i = 0; i < nblocks; i++) sha256_block(state, data + 64 * i);
}

// Streaming context so multi-part inputs (chunk header + body) hash without
// concatenating into a scratch buffer.
struct Sha256Stream {
  uint32_t st[8];
  uint8_t buf[64];
  uint64_t total = 0;
  uint32_t buffered = 0;
};

static void sha256_stream_init(Sha256Stream &s) {
  static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
  copy_bytes(s.st, init, sizeof(init));
  s.total = 0;
  s.buffered = 0;
}

static void sha256_stream_update(Sha256Stream &s, const uint8_t *p,
                                 uint64_t n) {
  s.total += n;
  if (s.buffered) {
    uint64_t take = 64 - s.buffered < n ? 64 - s.buffered : n;
    copy_bytes(s.buf + s.buffered, p, take);
    s.buffered += uint32_t(take);
    p += take;
    n -= take;
    if (s.buffered == 64) {
      sha256_blocks(s.st, s.buf, 1);
      s.buffered = 0;
    }
  }
  uint64_t full = n / 64;
  if (full) {
    sha256_blocks(s.st, p, full);
    p += 64 * full;
    n -= 64 * full;
  }
  if (n) {
    copy_bytes(s.buf, p, n);
    s.buffered = uint32_t(n);
  }
}

static void sha256_stream_final(Sha256Stream &s, uint8_t *out) {
  uint8_t tail[128];
  uint32_t rem = s.buffered;
  copy_bytes(tail, s.buf, rem);
  tail[rem] = 0x80;
  uint64_t tail_len = (rem + 9 <= 64) ? 64 : 128;
  memset(tail + rem + 1, 0, tail_len - rem - 9);
  uint64_t bits = s.total * 8;
  for (int i = 0; i < 8; i++)
    tail[tail_len - 1 - i] = uint8_t(bits >> (8 * i));
  sha256_blocks(s.st, tail, tail_len / 64);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = uint8_t(s.st[i] >> 24);
    out[4 * i + 1] = uint8_t(s.st[i] >> 16);
    out[4 * i + 2] = uint8_t(s.st[i] >> 8);
    out[4 * i + 3] = uint8_t(s.st[i]);
  }
}

// out must have room for 32 bytes
void am_sha256(const uint8_t *data, uint64_t len, uint8_t *out) {
  Sha256Stream s;
  sha256_stream_init(s);
  sha256_stream_update(s, data, len);
  sha256_stream_final(s, out);
}

// Defined next to the thread pool (below): fans the batch over the pool
// when it is worth it. Returns false when the caller should hash serially.
static bool sha256_batch_parallel(const uint8_t *data, const uint64_t *offsets,
                                  const uint64_t *lens, uint64_t n,
                                  uint8_t *out);

// Batched hashing: n buffers, each lens[i] bytes at data + offsets[i];
// out receives n * 32 bytes. The per-doc hash chains of a fleet are
// independent, so this parallelizes across documents (SURVEY.md section 7
// hard part 5: batch across docs, not within a doc) — long contiguous
// runs per worker keep the SHA-NI block loop hot instead of interleaving
// per-chunk state swaps.
void am_sha256_batch(const uint8_t *data, const uint64_t *offsets,
                     const uint64_t *lens, uint64_t n, uint8_t *out) {
  if (sha256_batch_parallel(data, offsets, lens, n, out)) return;
  for (uint64_t i = 0; i < n; i++) {
    am_sha256(data + offsets[i], lens[i], out + 32 * i);
  }
}

// ---------------------------------------------------------------------------
// Raw DEFLATE via zlib (the reference uses pako: columnar.js:1)
// ---------------------------------------------------------------------------

// Returns compressed size, or -1 on error. out_cap must be generous.
int64_t am_deflate_raw(const uint8_t *data, uint64_t len, uint8_t *out,
                       uint64_t out_cap) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  zs.next_in = const_cast<uint8_t *>(data);
  zs.avail_in = uInt(len);
  zs.next_out = out;
  zs.avail_out = uInt(out_cap);
  int ret = deflate(&zs, Z_FINISH);
  deflateEnd(&zs);
  if (ret != Z_STREAM_END) return -1;
  return int64_t(out_cap - zs.avail_out);
}

int64_t am_inflate_raw(const uint8_t *data, uint64_t len, uint8_t *out,
                       uint64_t out_cap) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return -1;
  zs.next_in = const_cast<uint8_t *>(data);
  zs.avail_in = uInt(len);
  zs.next_out = out;
  zs.avail_out = uInt(out_cap);
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (ret != Z_STREAM_END) return -1;
  return int64_t(out_cap - zs.avail_out);
}

// ---------------------------------------------------------------------------
// LEB128 (ref encoding.js:97-230)
// ---------------------------------------------------------------------------

// Reads one unsigned LEB128; advances *pos; returns value or sets *err.
static inline uint64_t read_uleb(const uint8_t *buf, uint64_t len,
                                 uint64_t *pos, int *err) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t byte = buf[(*pos)++];
    if (shift >= 64) { *err = 1; return 0; }
    result |= uint64_t(byte & 0x7f) << shift;
    shift += 7;
    if ((byte & 0x80) == 0) return result;
  }
  *err = 1;
  return 0;
}

static inline int64_t read_sleb(const uint8_t *buf, uint64_t len,
                                uint64_t *pos, int *err) {
  // assembled unsigned: a signed left shift that reaches bit 63 is UB
  // (a 10-byte hostile varint put `42 << 63` here under UBSan), while
  // unsigned shifts just discard the overflow like the JS reference
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t byte = buf[(*pos)++];
    if (shift >= 64) { *err = 1; return 0; }
    result |= uint64_t(byte & 0x7f) << shift;
    shift += 7;
    if ((byte & 0x80) == 0) {
      if ((byte & 0x40) && shift < 64) result |= ~uint64_t(0) << shift;
      return int64_t(result);
    }
  }
  *err = 1;
  return 0;
}

// ---------------------------------------------------------------------------
// Column decoders (ref encoding.js RLEDecoder/DeltaDecoder/BooleanDecoder)
//
// Each decodes an entire column buffer into out[0..cap) int64 values with a
// validity mask (0 = null), returning the number of values decoded or -1 on
// malformed input / overflow. This is the "decode straight into padded
// arrays" path: the output arrays are reused as device-transfer staging.
// ---------------------------------------------------------------------------

int64_t am_decode_rle(const uint8_t *buf, uint64_t len, int is_signed,
                      int64_t *out, uint8_t *mask, int64_t cap) {
  uint64_t pos = 0;
  int64_t n = 0;
  int err = 0;
  int64_t last_value = 0;
  int have_last = 0, last_was_literal = 0, last_was_nulls = 0;
  while (pos < len) {
    int64_t count = read_sleb(buf, len, &pos, &err);
    if (err) return -1;
    if (count > 1) {
      int64_t value = is_signed ? read_sleb(buf, len, &pos, &err)
                                : int64_t(read_uleb(buf, len, &pos, &err));
      if (err) return -1;
      if (have_last && !last_was_nulls && last_value == value) return -1;
      // overflow-proof form of n + count > cap: cap - n never underflows
      // (n <= cap invariant), and a hostile count near INT64_MAX would
      // wrap a naive signed addition past the check
      if (count > cap - n) return -1;
      for (int64_t i = 0; i < count; i++) { out[n] = value; mask[n] = 1; n++; }
      last_value = value; have_last = 1; last_was_literal = 0; last_was_nulls = 0;
    } else if (count == 1) {
      return -1;  // repetition count of 1 is not allowed
    } else if (count < 0) {
      if (last_was_literal) return -1;  // successive literals not allowed
      if (count == INT64_MIN) return -1;  // -count would overflow (UB)
      int64_t m = -count;
      if (m > cap - n) return -1;
      for (int64_t i = 0; i < m; i++) {
        int64_t value = is_signed ? read_sleb(buf, len, &pos, &err)
                                  : int64_t(read_uleb(buf, len, &pos, &err));
        if (err) return -1;
        if (have_last && !last_was_nulls && value == last_value) return -1;
        out[n] = value; mask[n] = 1; n++;
        last_value = value; have_last = 1;
      }
      last_was_literal = 1; last_was_nulls = 0;
    } else {  // count == 0: null run
      if (last_was_nulls) return -1;
      uint64_t m = read_uleb(buf, len, &pos, &err);
      if (err || m == 0) return -1;
      if (m > uint64_t(cap - n)) return -1;  // uint64 space: no overflow
      for (uint64_t i = 0; i < m; i++) { out[n] = 0; mask[n] = 0; n++; }
      last_was_nulls = 1; last_was_literal = 0;
    }
  }
  return n;
}

int64_t am_decode_delta(const uint8_t *buf, uint64_t len, int64_t *out,
                        uint8_t *mask, int64_t cap) {
  // Delta = RLE('int') of successive differences; accumulate absolutes
  int64_t n = am_decode_rle(buf, len, 1, out, mask, cap);
  if (n < 0) return -1;
  int64_t absolute = 0;
  for (int64_t i = 0; i < n; i++) {
    if (mask[i]) {
      absolute += out[i];
      out[i] = absolute;
    }
  }
  return n;
}

// Returns the decoded count, -1 for malformed bytes, or -2 when the
// output capacity is too small (callers retry with a bigger buffer; a
// malformed column must NOT look like that, or hostile run counts send
// the retry loop into multi-GB allocations). The capacity check
// compares in uint64 space: a hostile LEB run count near 2^64 would
// overflow int64 and sail past a signed `n + count > cap` check — the
// classic heap-smash the wire fuzzer caught.
int64_t am_decode_boolean(const uint8_t *buf, uint64_t len, int64_t *out,
                          uint8_t *mask, int64_t cap) {
  uint64_t pos = 0;
  int64_t n = 0;
  int err = 0;
  int value = 0, first = 1;
  while (pos < len) {
    uint64_t count = read_uleb(buf, len, &pos, &err);
    if (err) return -1;
    if (count == 0 && !first) return -1;  // zero-length runs not allowed
    if (count > uint64_t(cap - n)) return -2;
    for (uint64_t i = 0; i < count; i++) { out[n] = value; mask[n] = 1; n++; }
    value = !value;
    first = 0;
  }
  return n;
}

// Counts values in an RLE/delta column without materializing them.
// Totals are capped at kMaxColumnValues: RLE expansion is unbounded by
// construction, so a few hostile bytes could otherwise declare 2^60
// values and turn the caller's allocation into a multi-GB DoS (or wrap
// the signed accumulator into a bogus non-negative count).
static const int64_t kMaxColumnValues = int64_t(1) << 26;

int64_t am_count_rle(const uint8_t *buf, uint64_t len, int is_signed) {
  uint64_t pos = 0;
  int64_t n = 0;
  int err = 0;
  while (pos < len) {
    int64_t count = read_sleb(buf, len, &pos, &err);
    if (err) return -1;
    if (count > 1) {
      if (is_signed) read_sleb(buf, len, &pos, &err);
      else read_uleb(buf, len, &pos, &err);
      if (err) return -1;
      if (count > kMaxColumnValues - n) return -1;
      n += count;
    } else if (count == 1) {
      return -1;
    } else if (count < 0) {
      if (count == INT64_MIN) return -1;  // -count would overflow (UB)
      for (int64_t i = 0; i < -count; i++) {
        if (is_signed) read_sleb(buf, len, &pos, &err);
        else read_uleb(buf, len, &pos, &err);
        if (err) return -1;
      }
      if (-count > kMaxColumnValues - n) return -1;
      n += -count;
    } else {
      uint64_t m = read_uleb(buf, len, &pos, &err);
      if (err) return -1;
      if (m > uint64_t(kMaxColumnValues - n)) return -1;
      n += int64_t(m);
    }
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched change ingest: parse whole binary changes into fleet op rows.
//
// One call parses N change chunks (possibly DEFLATE-compressed), decodes
// their header + columns, dictionary-encodes map keys and actor ids, and
// emits flat op-row arrays ready to scatter into OpBatch tensors. This is
// the host runtime leg of the wire->device pipeline; doing it in C++ removes
// the per-change Python orchestration cost.
//
// Supports the fleet-kernel subset: root-map set/inc/del ops with integer
// values (LEB128 uint/int/counter/timestamp). Returns -1 if any change needs
// the general host engine.
// ---------------------------------------------------------------------------

#include <pthread.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <ctime>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// CLOCK_MONOTONIC nanoseconds — the SAME epoch CPython's
// time.perf_counter_ns() reads on Linux, so slice timings exported to the
// Python span ring line up with host-phase spans in one Perfetto timeline.
static int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000ll + ts.tv_nsec;
}

// ---------------------------------------------------------------------------
// Persistent native thread pool (the multi-core parse engine).
//
// One pool per process, lazily spawned, sized by am_pool_configure (the
// Python wrapper feeds AUTOMERGE_TPU_NATIVE_THREADS). The caller thread
// participates as worker 0, so `threads` == concurrent lanes, not helper
// count. run() is a blocking fork-join over an atomic task counter; jobs
// are serialized by run_m_ (the codec's ingest contexts are single-flight
// anyway). All sync objects live behind pointers so the pthread_atfork
// child handler can abandon them wholesale: in a forked child the worker
// threads do not exist and any mutex held at fork time is locked forever —
// leaking a few kilobytes beats deadlocking the child's first parse.
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 64;

class NativePool {
 public:
  static NativePool &inst() {
    static NativePool *p = new NativePool();  // leaked: no exit-order races
    return *p;
  }

  int configure(int n) {
    if (n < 1) n = 1;
    if (n > kMaxThreads) n = kMaxThreads;
    std::lock_guard<std::mutex> rg(*run_m_);  // never mid-job
    std::unique_lock<std::mutex> lk(*m_);
    target_ = n;
    if (int(workers_->size()) > target_ - 1) {
      // shrink: stop everyone; they respawn lazily up to target-1
      stop_ = true;
      cv_->notify_all();
      lk.unlock();
      for (auto &t : *workers_) t.join();
      workers_->clear();
      lk.lock();
      stop_ = false;
    }
    return target_;
  }

  int threads() {
    std::lock_guard<std::mutex> lk(*m_);
    return target_;
  }

  // Run fn(task, worker) for every task in [0, n_tasks); caller included
  // as worker 0. Blocks until all tasks completed AND helpers are idle
  // (no straggler may observe the next job's half-written state).
  void run(int n_tasks, const std::function<void(int, int)> &fn) {
    if (n_tasks <= 0) return;
    std::lock_guard<std::mutex> rg(*run_m_);
    {
      std::unique_lock<std::mutex> lk(*m_);
      while (int(workers_->size()) < target_ - 1) {
        int widx = int(workers_->size()) + 1;
        workers_->emplace_back([this, widx] { worker_main(widx); });
      }
      cv_done_->wait(lk, [&] { return active_ == 0; });  // flush stragglers
      job_ = &fn;
      n_tasks_ = n_tasks;
      next_task_.store(0, std::memory_order_relaxed);
      completed_.store(0, std::memory_order_relaxed);
      gen_++;
      cv_->notify_all();
    }
    work(0);
    std::unique_lock<std::mutex> lk(*m_);
    cv_done_->wait(lk, [&] {
      return completed_.load(std::memory_order_acquire) >= n_tasks_ &&
             active_ == 0;
    });
    job_ = nullptr;
  }

  int64_t tasks() const { return tasks_total_.load(); }
  int64_t busy_ns() const { return busy_ns_total_.load(); }

  void reset_after_fork() {
    m_ = new std::mutex();
    cv_ = new std::condition_variable();
    cv_done_ = new std::condition_variable();
    run_m_ = new std::mutex();
    workers_ = new std::vector<std::thread>();  // old handles abandoned
    active_ = 0;
    stop_ = false;
  }

 private:
  NativePool() {
    reset_after_fork();  // initial allocation of the sync objects
    pthread_atfork(nullptr, nullptr, [] { inst().reset_after_fork(); });
  }

  void worker_main(int widx) {
    std::unique_lock<std::mutex> lk(*m_);
    // seen = 0, NOT gen_: a worker spawned by run() first acquires the
    // mutex after the spawning job's gen bump — reading gen_ here would
    // make it sleep through that job (entering a finished job's state is
    // safe: the exhausted task counter bounces it straight back to wait)
    int64_t seen = 0;
    for (;;) {
      cv_->wait(lk, [&] { return stop_ || gen_ != seen; });
      if (stop_) return;
      seen = gen_;
      active_++;
      lk.unlock();
      work(widx);
      lk.lock();
      if (--active_ == 0) cv_done_->notify_all();
    }
  }

  void work(int widx) {
    for (;;) {
      int t = next_task_.fetch_add(1, std::memory_order_relaxed);
      if (t >= n_tasks_) break;
      int64_t t0 = now_ns();
      (*job_)(t, widx);
      busy_ns_total_.fetch_add(now_ns() - t0, std::memory_order_relaxed);
      tasks_total_.fetch_add(1, std::memory_order_relaxed);
      completed_.fetch_add(1, std::memory_order_release);
    }
  }

  std::mutex *m_ = nullptr;
  std::mutex *run_m_ = nullptr;
  std::condition_variable *cv_ = nullptr;
  std::condition_variable *cv_done_ = nullptr;
  std::vector<std::thread> *workers_ = nullptr;
  const std::function<void(int, int)> *job_ = nullptr;
  int target_ = 1;
  int n_tasks_ = 0;
  int active_ = 0;
  bool stop_ = false;
  int64_t gen_ = 0;
  std::atomic<int> next_task_{0};
  std::atomic<int> completed_{0};
  std::atomic<int64_t> tasks_total_{0};
  std::atomic<int64_t> busy_ns_total_{0};
};

// Slices per job: a few per lane balances byte-size skew across chunks
// without per-chunk dispatch overhead.
static uint64_t slice_count(uint64_t n, int threads) {
  uint64_t target = uint64_t(threads) * 4;
  return n < target ? n : target;
}

}  // namespace

// Disjoint per-worker output ranges make the parallel batch trivially
// byte-identical to the serial loop. Below 64 buffers the pool wake-up
// costs more than the hashing. (Braced extern "C" so the language
// linkage matches the forward declaration in the first extern "C" block.)
extern "C" {
static bool sha256_batch_parallel(const uint8_t *data,
                                  const uint64_t *offsets,
                                  const uint64_t *lens, uint64_t n,
                                  uint8_t *out) {
  int threads = NativePool::inst().threads();
  if (threads <= 1 || n < 64) return false;
  uint64_t n_slices = slice_count(n, threads);
  NativePool::inst().run(int(n_slices), [&](int t, int) {
    uint64_t lo = n * uint64_t(t) / n_slices;
    uint64_t hi = n * uint64_t(t + 1) / n_slices;
    for (uint64_t i = lo; i < hi; i++)
      am_sha256(data + offsets[i], lens[i], out + 32 * i);
  });
  return true;
}
}  // extern "C"

namespace {

// Per-slice parse timings of the LAST ingest call (exported to the span
// ring / parse_chunk_s histogram by the Python wrapper).
struct ParseStats {
  int64_t wall_t0 = 0, wall_t1 = 0;
  int64_t threads = 1;
  struct Slice { int64_t t0, t1, first, count, worker; };
  std::vector<Slice> slices;
};
static ParseStats g_parse_stats;

struct Cursor {
  const uint8_t *buf;
  uint64_t len;
  uint64_t pos = 0;
  bool fail = false;

  uint64_t uleb() {
    int err = 0;
    uint64_t v = read_uleb(buf, len, &pos, &err);
    if (err) fail = true;
    return v;
  }
  int64_t sleb() {
    int err = 0;
    int64_t v = read_sleb(buf, len, &pos, &err);
    if (err) fail = true;
    return v;
  }
  void skip(uint64_t n) {
    if (pos + n > len) { fail = true; return; }
    pos += n;
  }
  const uint8_t *bytes(uint64_t n) {
    if (pos + n > len) { fail = true; return nullptr; }
    const uint8_t *p = buf + pos;
    pos += n;
    return p;
  }
};

struct Interner {
  std::unordered_map<std::string, int32_t> index;
  std::vector<std::string> items;

  int32_t intern(const std::string &s) {
    auto it = index.find(s);
    if (it != index.end()) return it->second;
    int32_t id = int32_t(items.size());
    index.emplace(s, id);
    items.push_back(s);
    return id;
  }
};

// Per-change parse scratch, reused across the batch so the hot loop does no
// heap allocation after the first few changes (clear() keeps capacity).
struct ParseScratch {
  std::vector<int32_t> actor_table;
  std::vector<uint32_t> col_ids;
  std::vector<uint64_t> col_lens;
  std::vector<const uint8_t *> col_bufs;
  std::vector<int32_t> key_ids;
  std::vector<int64_t> actions, val_lens, obj_ctr, insert_i64;
  std::vector<uint8_t> actions_ok, val_lens_ok, obj_ctr_ok, insert_ok;
  std::vector<int64_t> pred_num, pred_actor, pred_ctr;
  std::vector<uint8_t> pred_num_ok, pred_actor_ok, pred_ctr_ok;
  std::vector<int64_t> obj_actor, key_actor, key_ctr;
  std::vector<uint8_t> obj_actor_ok, key_actor_ok, key_ctr_ok;
  std::vector<int64_t> bool_v;
  std::vector<uint8_t> bool_m;

  void reset() {
    actor_table.clear();
    col_ids.clear();
    col_lens.clear();
    col_bufs.clear();
    key_ids.clear();
    actions.clear();
    val_lens.clear();
    obj_ctr.clear();
    insert_i64.clear();
    actions_ok.clear();
    val_lens_ok.clear();
    obj_ctr_ok.clear();
    insert_ok.clear();
    pred_num.clear();
    pred_actor.clear();
    pred_ctr.clear();
    pred_num_ok.clear();
    pred_actor_ok.clear();
    pred_ctr_ok.clear();
    obj_actor.clear();
    key_actor.clear();
    key_ctr.clear();
    obj_actor_ok.clear();
    key_actor_ok.clear();
    key_ctr_ok.clear();
  }
};

struct IngestCtx {
  Interner keys, actors;
  // Raw actor bytes -> interned id, skipping the hex conversion + string
  // intern on the (hot) repeated-actor case. The first 32 distinct actors
  // also land in a linear memcmp cache (no per-lookup allocation).
  std::unordered_map<std::string, int32_t> actor_raw_cache;
  std::vector<std::string> actor_lin_keys;
  std::vector<int32_t> actor_lin_ids;
  ParseScratch scratch;
  std::vector<int32_t> out_doc, out_key, out_packed, out_val;
  std::vector<uint8_t> out_flags;  // 1 = set/del, 2 = inc
  std::string error;
  // Per-change metadata (filled only when am_ingest_changes gets
  // with_meta=1): header fields + full SHA-256 chunk hash, so the causal
  // gate / hash graph never needs a Python-side header decode.
  std::vector<int32_t> m_actor;
  std::vector<int64_t> m_seq, m_start_op, m_time, m_nops;
  std::vector<uint8_t> m_hash;      // 32 bytes per change
  std::vector<int64_t> m_deps_off;  // per change, index into m_deps/32
  std::vector<uint8_t> m_deps;      // 32 bytes per dep, concatenated
  std::vector<int64_t> m_msg_off;   // per change, byte offset into m_msg
  std::vector<uint8_t> m_msg;       // UTF-8 message bytes, concatenated
  std::vector<int64_t> m_buf_len;   // per change, wire buffer byte length
  // Per-op pred lists (with_meta only): out_pred_off[i] indexes the first
  // pred of op row i in out_pred; packed as (ctr << kActorBits) | actor
  // with GLOBAL actor numbers (the per-change actor table is interned)
  std::vector<int64_t> out_pred_off;
  std::vector<int32_t> out_pred;
  // Sequence-op columns (with_seq only): packed objectId (0 = root map),
  // packed referent elemId (0 = head/none), wire value-type tag low nibble
  std::vector<int32_t> out_obj, out_ref;
  std::vector<uint8_t> out_vtype;
  // Boxed-value passthrough (with_seq only): rows whose payload an int32
  // lane can't carry (strings/floats/bytes, multi-char text) get their raw
  // wire value bytes appended here; out_vlen is 0 for inline-value rows
  std::vector<int32_t> out_vlen;
  std::vector<uint8_t> val_arena;
};

// Intern an actor given its raw (binary) bytes, caching by raw bytes so the
// hex conversion + string intern runs once per distinct actor per batch.
// The hit path scans a small linear cache with memcmp — batches hold a
// handful of distinct actors, and the hash-map path's std::string key
// construction per change was a measurable slice of the meta parse.
static int32_t intern_actor_raw(IngestCtx &ctx, const uint8_t *raw,
                                uint64_t len) {
  size_t n_lin = ctx.actor_lin_keys.size();
  for (size_t i = 0; i < n_lin; i++) {
    const std::string &k = ctx.actor_lin_keys[i];
    if (k.size() == len && memcmp(k.data(), raw, len) == 0)
      return ctx.actor_lin_ids[i];
  }
  std::string key((const char *)raw, len);
  auto it = ctx.actor_raw_cache.find(key);
  if (it != ctx.actor_raw_cache.end()) return it->second;
  static const char *hex = "0123456789abcdef";
  std::string actor_hex;
  actor_hex.reserve(len * 2);
  for (uint64_t i = 0; i < len; i++) {
    actor_hex.push_back(hex[raw[i] >> 4]);
    actor_hex.push_back(hex[raw[i] & 15]);
  }
  int32_t id = ctx.actors.intern(actor_hex);
  if (ctx.actor_lin_keys.size() < 32) {
    ctx.actor_lin_keys.push_back(key);
    ctx.actor_lin_ids.push_back(id);
  }
  ctx.actor_raw_cache.emplace(std::move(key), id);
  return id;
}

// SHA-256 of a change chunk as the reference hashes it (columnar.js:688-708):
// over [chunk type 1][uleb body length][uncompressed body].
static void change_chunk_hash(const uint8_t *body, uint64_t body_len,
                              uint8_t out[32]) {
  uint8_t header[11];
  uint64_t n = 0;
  header[n++] = 1;
  uint64_t v = body_len;
  do {
    uint8_t b = v & 0x7f;
    v >>= 7;
    if (v) b |= 0x80;
    header[n++] = b;
  } while (v);
  Sha256Stream s;
  sha256_stream_init(s);
  sha256_stream_update(s, header, n);
  sha256_stream_update(s, body, body_len);
  sha256_stream_final(s, out);
}

constexpr int kColObjActor = 0x01, kColObjCtr = 0x02;
constexpr int kColKeyActor = 0x11, kColKeyCtr = 0x13, kColKeyStr = 0x15;
constexpr int kColInsert = 0x34, kColAction = 0x42;
constexpr int kColValLen = 0x56, kColValRaw = 0x57;
constexpr int kColPredNum = 0x70, kColPredActor = 0x71, kColPredCtr = 0x73;
constexpr int kActionSet = 1, kActionDel = 3, kActionInc = 5;
constexpr int kActionMakeMap = 0, kActionMakeList = 2;
constexpr int kActionMakeText = 4, kActionMakeTable = 6;
constexpr int kActorBits = 8;

// Decode a UTF-8 buffer holding EXACTLY one code point; returns it or -1.
// Text-element payloads are single characters in the hot editing path —
// multi-char / non-string values fall back to the host value table.
static int64_t utf8_single_cp(const uint8_t *p, uint64_t n) {
  if (n == 0 || p == nullptr) return -1;
  uint32_t cp;
  uint64_t need;
  uint8_t b = p[0];
  if (b < 0x80) { cp = b; need = 1; }
  else if ((b >> 5) == 6) { cp = b & 0x1f; need = 2; }
  else if ((b >> 4) == 14) { cp = b & 0x0f; need = 3; }
  else if ((b >> 3) == 30) { cp = b & 0x07; need = 4; }
  else return -1;
  if (n != need) return -1;
  for (uint64_t i = 1; i < need; i++) {
    if ((p[i] >> 6) != 2) return -1;
    cp = (cp << 6) | (p[i] & 0x3f);
  }
  // Match Python's strict UTF-8 decode (encoding.py read_prefixed_string):
  // reject overlong encodings, surrogates, and out-of-range code points —
  // otherwise turbo would commit values whose later chr()/encode crashes.
  static const uint32_t min_cp[5] = {0, 0, 0x80, 0x800, 0x10000};
  if (cp < min_cp[need]) return -1;              // overlong
  if (cp >= 0xd800 && cp <= 0xdfff) return -1;   // surrogate
  if (cp > 0x10ffff) return -1;
  return int64_t(cp);
}

// Decode an RLE utf8 column into interned key ids (-1 = null)
bool decode_keystr(const uint8_t *buf, uint64_t len, Interner &keys,
                   std::vector<int32_t> &out) {
  Cursor c{buf, len};
  while (c.pos < c.len && !c.fail) {
    int64_t count = c.sleb();
    if (c.fail) return false;
    if (count > 1) {
      uint64_t slen = c.uleb();
      const uint8_t *p = c.bytes(slen);
      if (c.fail) return false;
      int32_t id = keys.intern(std::string((const char *)p, slen));
      for (int64_t i = 0; i < count; i++) out.push_back(id);
    } else if (count == 1) {
      return false;
    } else if (count < 0) {
      for (int64_t i = 0; i < -count; i++) {
        uint64_t slen = c.uleb();
        const uint8_t *p = c.bytes(slen);
        if (c.fail) return false;
        out.push_back(keys.intern(std::string((const char *)p, slen)));
      }
    } else {
      uint64_t nulls = c.uleb();
      if (c.fail) return false;
      for (uint64_t i = 0; i < nulls; i++) out.push_back(-1);
    }
  }
  return !c.fail;
}

bool decode_i64_col(const uint8_t *buf, uint64_t len, bool is_signed,
                    bool is_delta, std::vector<int64_t> &vals,
                    std::vector<uint8_t> &mask) {
  int64_t count = am_count_rle(buf, len, is_signed || is_delta);
  if (count < 0) return false;
  vals.resize(size_t(count));
  mask.resize(size_t(count));
  if (count == 0) return true;
  int64_t n = is_delta
      ? am_decode_delta(buf, len, vals.data(), mask.data(), count)
      : am_decode_rle(buf, len, is_signed ? 1 : 0, vals.data(), mask.data(),
                      count);
  return n == count;
}

}  // namespace

extern "C" {

// Implemented without the goto mess: parse body given the chunk *contents*
// (after the 8-byte magic+checksum, 1-byte type, LEB length header).
static bool parse_change_body(IngestCtx &ctx, const uint8_t *body,
                              uint64_t body_len, int32_t doc,
                              int with_meta, int with_seq,
                              const uint8_t *checksum) {
  size_t rows_before = ctx.out_doc.size();
  if (with_meta) {
    uint8_t digest[32];
    change_chunk_hash(body, body_len, digest);
    if (memcmp(digest, checksum, 4) != 0) return false;  // corrupt chunk
    ctx.m_hash.insert(ctx.m_hash.end(), digest, digest + 32);
  }
  Cursor c{body, body_len};
  uint64_t num_deps = c.uleb();
  if (with_meta) {
    ctx.m_deps_off.push_back(int64_t(ctx.m_deps.size() / 32));
    const uint8_t *deps = c.bytes(32 * num_deps);
    if (c.fail) return false;
    ctx.m_deps.insert(ctx.m_deps.end(), deps, deps + 32 * num_deps);
  } else {
    c.skip(32 * num_deps);
  }
  // actor hex string (length-prefixed bytes)
  uint64_t actor_len = c.uleb();
  const uint8_t *actor_bytes = c.bytes(actor_len);
  if (c.fail) return false;
  int32_t actor_id = intern_actor_raw(ctx, actor_bytes, actor_len);
  if (actor_id >= (1 << kActorBits)) return false;
  uint64_t seq = c.uleb();
  uint64_t start_op = c.uleb();   // startOp
  int64_t time = c.sleb();
  uint64_t msg_len = c.uleb();    // message
  if (with_meta) {
    ctx.m_actor.push_back(actor_id);
    ctx.m_seq.push_back(int64_t(seq));
    ctx.m_start_op.push_back(int64_t(start_op));
    ctx.m_time.push_back(time);
    ctx.m_msg_off.push_back(int64_t(ctx.m_msg.size()));
    const uint8_t *msg = c.bytes(msg_len);
    if (c.fail) return false;
    ctx.m_msg.insert(ctx.m_msg.end(), msg, msg + msg_len);
  } else {
    c.skip(msg_len);
  }
  ParseScratch &sc = ctx.scratch;
  sc.reset();
  std::vector<int32_t> &actor_table = sc.actor_table;
  actor_table.push_back(actor_id);
  uint64_t num_other_actors = c.uleb();
  for (uint64_t i = 0; i < num_other_actors; i++) {
    uint64_t alen = c.uleb();
    const uint8_t *abytes = c.bytes(alen);
    if (c.fail) return false;
    if (with_meta) {
      int32_t oid = intern_actor_raw(ctx, abytes, alen);
      if (oid >= (1 << kActorBits)) return false;
      actor_table.push_back(oid);
    }
  }
  if (c.fail) return false;

  uint64_t num_cols = c.uleb();
  std::vector<uint64_t> &col_lens = sc.col_lens;
  std::vector<uint32_t> &col_ids = sc.col_ids;
  for (uint64_t i = 0; i < num_cols; i++) {
    uint32_t cid = uint32_t(c.uleb());
    uint64_t blen = c.uleb();
    col_ids.push_back(cid);
    col_lens.push_back(blen);
  }
  if (c.fail) return false;
  std::vector<const uint8_t *> &col_bufs = sc.col_bufs;
  for (uint64_t i = 0; i < num_cols; i++) {
    col_bufs.push_back(c.bytes(col_lens[i]));
  }
  if (c.fail) return false;

  std::vector<int32_t> &key_ids = sc.key_ids;
  std::vector<int64_t> &actions = sc.actions, &val_lens = sc.val_lens,
                       &obj_ctr = sc.obj_ctr;
  std::vector<uint8_t> &actions_ok = sc.actions_ok,
                       &val_lens_ok = sc.val_lens_ok,
                       &obj_ctr_ok = sc.obj_ctr_ok, &insert_ok = sc.insert_ok;
  std::vector<int64_t> &insert_i64 = sc.insert_i64;
  std::vector<int64_t> &pred_num = sc.pred_num, &pred_actor = sc.pred_actor,
                       &pred_ctr = sc.pred_ctr;
  std::vector<uint8_t> &pred_num_ok = sc.pred_num_ok,
                       &pred_actor_ok = sc.pred_actor_ok,
                       &pred_ctr_ok = sc.pred_ctr_ok;
  std::vector<int64_t> &obj_actor = sc.obj_actor, &key_actor = sc.key_actor,
                       &key_ctr = sc.key_ctr;
  std::vector<uint8_t> &obj_actor_ok = sc.obj_actor_ok,
                       &key_actor_ok = sc.key_actor_ok,
                       &key_ctr_ok = sc.key_ctr_ok;
  const uint8_t *val_raw = nullptr;
  uint64_t val_raw_len = 0;

  for (uint64_t i = 0; i < num_cols; i++) {
    uint32_t cid = col_ids[i];
    const uint8_t *b = col_bufs[i];
    uint64_t blen = col_lens[i];
    if (cid == kColKeyStr) {
      if (!decode_keystr(b, blen, ctx.keys, key_ids)) return false;
    } else if (cid == kColAction) {
      if (!decode_i64_col(b, blen, false, false, actions, actions_ok))
        return false;
    } else if (cid == kColValLen) {
      if (!decode_i64_col(b, blen, false, false, val_lens, val_lens_ok))
        return false;
    } else if (cid == kColValRaw) {
      val_raw = b;
      val_raw_len = blen;
    } else if (cid == kColObjCtr) {
      if (!decode_i64_col(b, blen, false, false, obj_ctr, obj_ctr_ok))
        return false;
    } else if (with_seq && cid == kColObjActor) {
      if (!decode_i64_col(b, blen, false, false, obj_actor, obj_actor_ok))
        return false;
    } else if (with_seq && cid == kColKeyActor) {
      if (!decode_i64_col(b, blen, false, false, key_actor, key_actor_ok))
        return false;
    } else if (with_seq && cid == kColKeyCtr) {
      if (!decode_i64_col(b, blen, true, true, key_ctr, key_ctr_ok))
        return false;
    } else if (with_meta && cid == kColPredNum) {
      if (!decode_i64_col(b, blen, false, false, pred_num, pred_num_ok))
        return false;
    } else if (with_meta && cid == kColPredActor) {
      if (!decode_i64_col(b, blen, false, false, pred_actor, pred_actor_ok))
        return false;
    } else if (with_meta && cid == kColPredCtr) {
      if (!decode_i64_col(b, blen, true, true, pred_ctr, pred_ctr_ok))
        return false;
    } else if (cid == kColInsert) {
      if (!decode_i64_col(b, blen, false, false, insert_i64, insert_ok)) {
        // boolean column needs the boolean decoder
        insert_i64.clear();
        insert_ok.clear();
      }
      // decode as boolean
      {
        int64_t cap = int64_t(sc.bool_v.size()) < 16
                          ? 16 : int64_t(sc.bool_v.size());
        std::vector<int64_t> &v = sc.bool_v;
        std::vector<uint8_t> &m = sc.bool_m;
        // -2 = capacity too small (retry bigger, bounded by the column
        // ceiling); -1 = malformed, fail immediately — a hostile run
        // count must not drive the resize loop toward bad_alloc
        int64_t n = -2;
        while (n == -2 && cap <= kMaxColumnValues) {
          v.resize(size_t(cap));
          m.resize(size_t(cap));
          n = am_decode_boolean(b, blen, v.data(), m.data(), cap);
          if (n == -2) cap *= 4;
        }
        if (n < 0) return false;
        insert_i64.assign(v.begin(), v.begin() + n);
      }
    }
    // other columns (keyActor/keyCtr, pred group, chld) are irrelevant for
    // root-map set/inc/del ingest; their presence with non-null content for
    // list ops is caught via key_ids null check below
  }

  uint64_t n_ops = actions.size();
  uint64_t raw_pos = 0;
  uint64_t pred_pos = 0;
  for (uint64_t i = 0; i < n_ops; i++) {
    int64_t action = actions[i];
    if (with_meta) {
      ctx.out_pred_off.push_back(int64_t(ctx.out_pred.size()));
      uint64_t np = 0;
      if (i < pred_num.size()) {
        if (!pred_num_ok[i]) return false;  // null group cardinality
        np = uint64_t(pred_num[i]);
      }
      for (uint64_t d = 0; d < np; d++, pred_pos++) {
        if (pred_pos >= pred_actor.size() || pred_pos >= pred_ctr.size())
          return false;
        if (!pred_actor_ok[pred_pos] || !pred_ctr_ok[pred_pos])
          return false;  // null entries inside a pred group are malformed
        uint64_t ta = uint64_t(pred_actor[pred_pos]);
        if (ta >= actor_table.size()) return false;
        int64_t pctr = pred_ctr[pred_pos];
        if (pctr <= 0 || pctr >= (int64_t(1) << (31 - kActorBits)))
          return false;
        ctx.out_pred.push_back(
            int32_t((pctr << kActorBits) | actor_table[ta]));
      }
    }
    bool is_root = !(i < obj_ctr.size() && obj_ctr_ok.size() > i &&
                     obj_ctr_ok[i]);
    bool insert = (i < insert_i64.size()) && insert_i64[i];
    int32_t key = (i < key_ids.size()) ? key_ids[i] : -1;
    int64_t tag = (i < val_lens.size() && val_lens_ok[i]) ? val_lens[i] : 0;
    uint64_t vsize = uint64_t(tag) >> 4;
    int vtype = int(tag & 0x0f);
    if (raw_pos + vsize > val_raw_len) return false;
    const uint8_t *vbytes = val_raw ? val_raw + raw_pos : nullptr;
    raw_pos += vsize;
    int64_t ctr = int64_t(start_op + i);
    if (ctr >= (int64_t(1) << (31 - kActorBits))) return false;
    int32_t self_packed = int32_t((ctr << kActorBits) | actor_id);

    // Containing object for non-root ops, packed (ctr << bits) | actor
    int32_t obj_packed = 0;
    if (!is_root) {
      if (i >= obj_actor.size() || !obj_actor_ok[i]) return false;
      uint64_t ta = uint64_t(obj_actor[i]);
      if (ta >= actor_table.size()) return false;
      int64_t objc = (i < obj_ctr.size()) ? obj_ctr[i] : 0;
      if (objc <= 0 || objc >= (int64_t(1) << (31 - kActorBits)))
        return false;
      obj_packed = int32_t((objc << kActorBits) | actor_table[ta]);
    }

    if (!is_root && with_seq && key < 0) {
      // ---- sequence element op (flags 3-6; makes 11-14) ----
      bool is_make = action == kActionMakeMap || action == kActionMakeList ||
          action == kActionMakeText || action == kActionMakeTable;
      if (!is_make && action != kActionSet && action != kActionDel &&
          action != kActionInc)
        return false;                 // link inside a sequence: host engine
      int32_t obj = obj_packed;
      // referent elemId: keyCtr 0 = '_head' (insert only); else packed
      if (i >= key_ctr.size() || !key_ctr_ok[i]) return false;
      int64_t kc = key_ctr[i];
      if (kc < 0 || kc >= (int64_t(1) << (31 - kActorBits))) return false;
      int32_t ref = 0;
      if (kc == 0) {
        if (!insert) return false;    // update needs a real target
      } else {
        if (i >= key_actor.size() || !key_actor_ok[i]) return false;
        uint64_t ka = uint64_t(key_actor[i]);
        if (ka >= actor_table.size()) return false;
        ref = int32_t((kc << kActorBits) | actor_table[ka]);
      }
      if (is_make) {
        // Object nested inside a sequence (rows-in-lists): flag-coded
        // 11 makeText, 12 makeList, 13 makeMap, 14 makeTable; the value
        // lane carries the insert bit (makes have no payload)
        if (vsize != 0) return false;
        uint8_t mk = action == kActionMakeText ? 11
            : action == kActionMakeList ? 12
            : action == kActionMakeMap ? 13 : 14;
        ctx.out_doc.push_back(doc);
        ctx.out_key.push_back(-1);
        ctx.out_packed.push_back(self_packed);
        ctx.out_val.push_back(insert ? 1 : 0);
        ctx.out_flags.push_back(mk);
        ctx.out_obj.push_back(obj);
        ctx.out_ref.push_back(ref);
        ctx.out_vtype.push_back(0);
        ctx.out_vlen.push_back(0);
        continue;
      }
      int64_t value = 0;
      uint8_t flags;
      if (action == kActionDel) {
        if (insert || vsize != 0) return false;
        flags = 5;
      } else if (action == kActionInc) {
        if (insert) return false;
        uint64_t p = 0;
        int err = 0;
        if (vtype == 3) value = int64_t(read_uleb(vbytes, vsize, &p, &err));
        else if (vtype == 4 || vtype == 8 || vtype == 9)
          value = read_sleb(vbytes, vsize, &p, &err);
        else return false;
        if (err || value <= -(int64_t(1) << 31) ||
            value >= (int64_t(1) << 31))
          return false;
        flags = 6;
      } else {
        uint64_t p = 0;
        int err = 0;
        bool boxed = false;
        if (vtype == 3) {
          value = int64_t(read_uleb(vbytes, vsize, &p, &err));
        } else if (vtype == 4 || vtype == 8 || vtype == 9) {
          value = read_sleb(vbytes, vsize, &p, &err);
        } else if (vtype == 6) {      // UTF-8: single code point inline,
          value = utf8_single_cp(vbytes, vsize);
          if (value < 0) {            // multi-char spans box via the arena
            value = 0;
            boxed = true;
          }
        } else if (vtype <= 9) {      // null/bool/float/bytes: arena
          value = 0;
          boxed = true;
        } else {
          return false;               // unknown value types: host engine
        }
        if (err) return false;
        if (!boxed && vtype != 6 &&
            (value < 0 || value >= (int64_t(1) << 31))) {
          value = 0;                  // out-of-int32-lane ints box too
          boxed = true;
        }
        flags = insert ? 3 : 4;
        if (boxed) {
          if (vsize == 0 && vtype >= 5) return false;  // malformed
          ctx.out_vlen.push_back(int32_t(vsize));
          ctx.val_arena.insert(ctx.val_arena.end(), vbytes, vbytes + vsize);
        } else {
          ctx.out_vlen.push_back(0);
        }
        ctx.out_doc.push_back(doc);
        ctx.out_key.push_back(-1);
        ctx.out_packed.push_back(self_packed);
        ctx.out_val.push_back(int32_t(value));
        ctx.out_flags.push_back(flags);
        ctx.out_obj.push_back(obj);
        ctx.out_ref.push_back(ref);
        ctx.out_vtype.push_back(uint8_t(vtype));
        continue;
      }
      ctx.out_doc.push_back(doc);
      ctx.out_key.push_back(-1);
      ctx.out_packed.push_back(self_packed);
      ctx.out_val.push_back(int32_t(value));
      ctx.out_flags.push_back(flags);
      ctx.out_obj.push_back(obj);
      ctx.out_ref.push_back(ref);
      ctx.out_vtype.push_back(uint8_t(vtype));
      ctx.out_vlen.push_back(0);
      continue;
    }

    // ---- keyed map/table op (root, or a nested object under with_seq;
    // without with_seq the flat register path accepts root only) ----
    if (!is_root && !with_seq) return false;
    if (insert) return false;
    if (key < 0) return false;
    if (with_seq && (action == kActionMakeText || action == kActionMakeList ||
                     action == kActionMakeMap || action == kActionMakeTable)) {
      // makes become flag-coded rows: 7 makeText, 8 makeList, 9 makeMap,
      // 10 makeTable; out_obj carries the (possibly nested) parent
      if (vsize != 0) return false;
      uint8_t mk = action == kActionMakeText ? 7
          : action == kActionMakeList ? 8
          : action == kActionMakeMap ? 9 : 10;
      ctx.out_doc.push_back(doc);
      ctx.out_key.push_back(key);
      ctx.out_packed.push_back(self_packed);
      ctx.out_val.push_back(0);
      ctx.out_flags.push_back(mk);
      ctx.out_obj.push_back(obj_packed);
      ctx.out_ref.push_back(0);
      ctx.out_vtype.push_back(0);
      ctx.out_vlen.push_back(0);
      continue;
    }

    int64_t value = 0;
    bool boxed = false;
    if (action == kActionSet || action == kActionInc) {
      uint64_t p = 0;
      int err = 0;
      if (vtype == 3) {  // LEB128 uint
        value = int64_t(read_uleb(vbytes, vsize, &p, &err));
      } else if (vtype == 4 || vtype == 8 || vtype == 9) {  // int/counter/ts
        value = read_sleb(vbytes, vsize, &p, &err);
      } else if (with_seq && action == kActionSet && vtype <= 9) {
        // null/bool/str/float/bytes set values ride the arena and box
        // host-side (the flat register path without with_seq keeps its
        // int-only contract)
        boxed = true;
      } else {
        return false;  // inc of a non-int / unknown value type: host path
      }
      if (err) return false;
      // inc deltas are raw int32 addends (negatives allowed); set values
      // must be non-negative inline ints (others box via the arena)
      if (action == kActionInc) {
        if (value <= -(int64_t(1) << 31) || value >= (int64_t(1) << 31))
          return false;
      } else if (!boxed && (value < 0 || value >= (int64_t(1) << 31))) {
        if (!with_seq) return false;
        boxed = true;               // out-of-lane ints box too
      }
      if (boxed) {
        if (vsize == 0 && vtype >= 5) return false;  // empty str/bytes/f64
        value = 0;
      }
    } else if (action != kActionDel) {
      return false;  // link needs the general engine
    }

    ctx.out_doc.push_back(doc);
    ctx.out_key.push_back(key);
    ctx.out_packed.push_back(self_packed);
    // A winning delete must be distinguishable from set-to-zero: deletions
    // carry the TOMBSTONE value (-1), matching tensor_doc.TOMBSTONE
    ctx.out_val.push_back(action == kActionDel ? -1 : int32_t(value));
    ctx.out_flags.push_back(action == kActionInc ? 2 : 1);
    if (with_seq) {
      ctx.out_obj.push_back(obj_packed);   // 0 = root; else nested parent
      ctx.out_ref.push_back(0);
      ctx.out_vtype.push_back(uint8_t(vtype));
      if (boxed) {
        ctx.out_vlen.push_back(int32_t(vsize));
        ctx.val_arena.insert(ctx.val_arena.end(), vbytes, vbytes + vsize);
      } else {
        ctx.out_vlen.push_back(0);
      }
    }
  }
  if (with_meta) ctx.m_nops.push_back(int64_t(ctx.out_doc.size() - rows_before));
  return true;
}

// One-shot batched ingest. Returns number of op rows, or -1 on any change
// that needs the general host engine. Outputs are retrieved with
// am_ingest_fetch (two-phase because row count is not known in advance).
static IngestCtx *g_ingest = nullptr;

// One-op-per-change is the common bulk shape: pre-size the output
// vectors to the batch so the hot loop never pays geometric-growth
// memcpys over multi-MB buffers.
static void ingest_reserve(IngestCtx &ctx, uint64_t n_changes,
                           int with_meta, int with_seq) {
  ctx.out_doc.reserve(n_changes);
  ctx.out_key.reserve(n_changes);
  ctx.out_packed.reserve(n_changes);
  ctx.out_val.reserve(n_changes);
  ctx.out_flags.reserve(n_changes);
  if (with_meta) {
    ctx.m_actor.reserve(n_changes);
    ctx.m_seq.reserve(n_changes);
    ctx.m_start_op.reserve(n_changes);
    ctx.m_time.reserve(n_changes);
    ctx.m_nops.reserve(n_changes);
    ctx.m_hash.reserve(32 * n_changes);
    ctx.m_deps.reserve(32 * n_changes);
    ctx.m_deps_off.reserve(n_changes);
    ctx.m_msg_off.reserve(n_changes);
    ctx.out_pred_off.reserve(n_changes);
    ctx.out_pred.reserve(n_changes);
  }
  if (with_seq) {
    ctx.out_obj.reserve(n_changes);
    ctx.out_ref.reserve(n_changes);
    ctx.out_vtype.reserve(n_changes);
    ctx.out_vlen.reserve(n_changes);
  }
}

// One change chunk into the global ingest context; returns false on any
// malformed/unsupported input (caller tears the context down).
static bool ingest_one_chunk(IngestCtx &ctx, const uint8_t *chunk,
                             uint64_t chunk_len, int32_t doc_id,
                             int with_meta, int with_seq) {
  if (chunk_len < 12) return false;
  // The checksum covers type+length+body but NOT the magic bytes, so
  // they must be checked explicitly: without this, a buffer whose magic
  // is corrupt parses "clean", its ops land on the device, and the raw
  // garbage bytes enter the change log where save()'s host decode later
  // explodes — silent acceptance instead of a typed quarantine (found
  // by the ISSUE-7 chaos client, pinned by
  // tests/test_service.py::test_corrupt_magic_is_quarantined_not_stored).
  if (memcmp(chunk, "\x85\x6f\x4a\x83", 4) != 0) return false;
  const uint8_t *body;
  uint64_t body_len;
  std::vector<uint8_t> inflated;
  Cursor hc{chunk, chunk_len};
  hc.skip(8);  // magic (verified above) + checksum (verified per body)
  uint8_t chunk_type = *hc.bytes(1);
  uint64_t blen = hc.uleb();
  const uint8_t *bptr = hc.bytes(blen);
  if (hc.fail) return false;
  if (chunk_type == 2) {  // deflated change
    size_t cap = blen * 16 + 1024;
    int64_t n = -1;
    while (n < 0 && cap < (size_t(1) << 28)) {
      inflated.resize(cap);
      n = am_inflate_raw(bptr, blen, inflated.data(), cap);
      if (n < 0) cap *= 4;
    }
    if (n < 0) return false;
    body = inflated.data();
    body_len = uint64_t(n);
  } else if (chunk_type == 1) {
    body = bptr;
    body_len = blen;
  } else {
    return false;
  }
  // The chunk header + declared body must span the whole buffer: buffers
  // holding concatenated chunks (split_containers territory) take the
  // exact path, where every chunk is applied
  if (hc.pos != chunk_len) return false;
  return parse_change_body(ctx, body, body_len, doc_id, with_meta,
                           with_seq, chunk + 4);
}

// Merge per-slice parse contexts into the global one, remapping every
// slice-local interned id into the global tables. Interning each slice's
// items IN SLICE ORDER reproduces exactly the first-occurrence order a
// serial chunk-order parse would assign, so the merged arrays are
// byte-identical to a single-threaded parse — same key/actor numbering,
// same packed opIds, same hashes — no matter how many workers ran or
// where the slice boundaries fell. Returns false when the merged actor
// table overflows the kActorBits packing (the serial parse fails the
// batch for the same population; both paths return -1).
static bool merge_ingest_slices(IngestCtx &g, std::vector<IngestCtx> &slices,
                                int with_meta, int with_seq) {
  size_t rows = 0, preds = 0, deps = 0, msgs = 0, arena = 0;
  for (auto &s : slices) {
    rows += s.out_doc.size();
    preds += s.out_pred.size();
    deps += s.m_deps.size();
    msgs += s.m_msg.size();
    arena += s.val_arena.size();
  }
  ingest_reserve(g, rows, with_meta, with_seq);
  g.out_pred.reserve(preds);
  g.m_deps.reserve(deps);
  g.m_msg.reserve(msgs);
  g.val_arena.reserve(arena);
  std::vector<int32_t> kmap, amap;
  for (auto &s : slices) {
    kmap.resize(s.keys.items.size());
    for (size_t i = 0; i < kmap.size(); i++)
      kmap[i] = g.keys.intern(s.keys.items[i]);
    amap.resize(s.actors.items.size());
    for (size_t i = 0; i < amap.size(); i++) {
      amap[i] = g.actors.intern(s.actors.items[i]);
      if (amap[i] >= (1 << kActorBits)) return false;
    }
    constexpr uint32_t kAMask = (1u << kActorBits) - 1;
    auto remap = [&](int32_t v) -> int32_t {
      return int32_t((uint32_t(v) & ~kAMask) |
                     uint32_t(amap[uint32_t(v) & kAMask]));
    };
    g.out_doc.insert(g.out_doc.end(), s.out_doc.begin(), s.out_doc.end());
    for (int32_t k : s.out_key) g.out_key.push_back(k < 0 ? k : kmap[k]);
    for (int32_t p : s.out_packed) g.out_packed.push_back(remap(p));
    g.out_val.insert(g.out_val.end(), s.out_val.begin(), s.out_val.end());
    g.out_flags.insert(g.out_flags.end(), s.out_flags.begin(),
                       s.out_flags.end());
    if (with_meta) {
      for (int32_t a : s.m_actor) g.m_actor.push_back(amap[a]);
      g.m_seq.insert(g.m_seq.end(), s.m_seq.begin(), s.m_seq.end());
      g.m_start_op.insert(g.m_start_op.end(), s.m_start_op.begin(),
                          s.m_start_op.end());
      g.m_time.insert(g.m_time.end(), s.m_time.begin(), s.m_time.end());
      g.m_nops.insert(g.m_nops.end(), s.m_nops.begin(), s.m_nops.end());
      g.m_hash.insert(g.m_hash.end(), s.m_hash.begin(), s.m_hash.end());
      int64_t dep_base = int64_t(g.m_deps.size() / 32);
      for (int64_t off : s.m_deps_off) g.m_deps_off.push_back(off + dep_base);
      g.m_deps.insert(g.m_deps.end(), s.m_deps.begin(), s.m_deps.end());
      int64_t msg_base = int64_t(g.m_msg.size());
      for (int64_t off : s.m_msg_off) g.m_msg_off.push_back(off + msg_base);
      g.m_msg.insert(g.m_msg.end(), s.m_msg.begin(), s.m_msg.end());
      int64_t pred_base = int64_t(g.out_pred.size());
      for (int64_t off : s.out_pred_off)
        g.out_pred_off.push_back(off + pred_base);
      for (int32_t p : s.out_pred) g.out_pred.push_back(remap(p));
    }
    if (with_seq) {
      // 0 is the root/none sentinel in obj/ref — never an actor number
      // (packed object/referent counters are >= 1 by parse validation)
      for (int32_t v : s.out_obj) g.out_obj.push_back(v == 0 ? 0 : remap(v));
      for (int32_t v : s.out_ref) g.out_ref.push_back(v == 0 ? 0 : remap(v));
      g.out_vtype.insert(g.out_vtype.end(), s.out_vtype.begin(),
                         s.out_vtype.end());
      g.out_vlen.insert(g.out_vlen.end(), s.out_vlen.begin(),
                        s.out_vlen.end());
      g.val_arena.insert(g.val_arena.end(), s.val_arena.begin(),
                         s.val_arena.end());
    }
  }
  return true;
}

// Chunk-parallel parse: contiguous chunk slices (balanced by byte size)
// parsed concurrently into per-slice contexts, then merged in slice order.
static bool ingest_parallel(IngestCtx &g, const uint8_t *const *ptrs,
                            const uint64_t *lens, const int32_t *doc_ids,
                            uint64_t n, int with_meta, int with_seq,
                            int threads) {
  uint64_t n_slices = slice_count(n, threads);
  std::vector<uint64_t> pre(n + 1, 0);
  for (uint64_t i = 0; i < n; i++) pre[i + 1] = pre[i] + lens[i];
  std::vector<uint64_t> bounds(n_slices + 1, 0);
  bounds[n_slices] = n;
  for (uint64_t s = 1; s < n_slices; s++) {
    uint64_t want = pre[n] / n_slices * s;
    uint64_t idx = uint64_t(
        std::lower_bound(pre.begin(), pre.end(), want) - pre.begin());
    uint64_t lo = bounds[s - 1] + 1, hi = n - (n_slices - s);
    bounds[s] = idx < lo ? lo : (idx > hi ? hi : idx);
  }
  std::vector<IngestCtx> slices(n_slices);
  std::vector<uint8_t> slice_ok(n_slices, 1);
  std::vector<ParseStats::Slice> stats(n_slices);
  std::atomic<bool> failed{false};
  NativePool::inst().run(int(n_slices), [&](int t, int w) {
    int64_t t0 = now_ns();
    IngestCtx &ctx = slices[size_t(t)];
    uint64_t lo = bounds[size_t(t)], hi = bounds[size_t(t) + 1];
    ingest_reserve(ctx, hi - lo, with_meta, with_seq);
    for (uint64_t i = lo; i < hi; i++) {
      if (failed.load(std::memory_order_relaxed)) {
        slice_ok[size_t(t)] = 0;   // sibling failed: the batch is dead
        break;
      }
      if (!ingest_one_chunk(ctx, ptrs[i], lens[i],
                            doc_ids ? doc_ids[i] : int32_t(i),
                            with_meta, with_seq)) {
        slice_ok[size_t(t)] = 0;
        failed.store(true, std::memory_order_relaxed);
        break;
      }
    }
    stats[size_t(t)] = {t0, now_ns(), int64_t(lo), int64_t(hi - lo), w};
  });
  g_parse_stats.slices = stats;
  for (uint8_t okf : slice_ok)
    if (!okf) return false;
  return merge_ingest_slices(g, slices, with_meta, with_seq);
}

// Shared entry: serial below 2 chunks or a 1-lane pool, chunk-parallel
// otherwise. Either way the resulting context (and therefore every fetch)
// is byte-identical; failure is all-or-nothing (-1) on both paths.
static int64_t ingest_dispatch(const uint8_t *const *ptrs,
                               const uint64_t *lens, const int32_t *doc_ids,
                               uint64_t n_changes, int with_meta,
                               int with_seq) {
  delete g_ingest;
  g_ingest = new IngestCtx();
  g_parse_stats.slices.clear();
  g_parse_stats.wall_t0 = now_ns();
  int threads = NativePool::inst().threads();
  bool ok;
  if (threads <= 1 || n_changes < 2) {
    g_parse_stats.threads = 1;
    ingest_reserve(*g_ingest, n_changes, with_meta, with_seq);
    ok = true;
    int64_t t0 = now_ns();
    for (uint64_t i = 0; i < n_changes; i++) {
      if (!ingest_one_chunk(*g_ingest, ptrs[i], lens[i],
                            doc_ids ? doc_ids[i] : int32_t(i),
                            with_meta, with_seq)) {
        ok = false;
        break;
      }
    }
    if (n_changes)
      g_parse_stats.slices.push_back(
          {t0, now_ns(), 0, int64_t(n_changes), 0});
  } else {
    g_parse_stats.threads = threads;
    ok = ingest_parallel(*g_ingest, ptrs, lens, doc_ids, n_changes,
                         with_meta, with_seq, threads);
  }
  g_parse_stats.wall_t1 = now_ns();
  if (!ok) {
    delete g_ingest;
    g_ingest = nullptr;
    return -1;
  }
  if (with_meta) {
    // Per-change wire byte lengths: a buffer is exactly one change here
    // (multi-chunk buffers are refused by ingest_one_chunk), so the
    // caller's bytes accounting never needs a Python-side len() pass.
    g_ingest->m_buf_len.reserve(n_changes);
    for (uint64_t i = 0; i < n_changes; i++)
      g_ingest->m_buf_len.push_back(int64_t(lens[i]));
  }
  return int64_t(g_ingest->out_doc.size());
}

int64_t am_ingest_changes(const uint8_t *blob, const uint64_t *offsets,
                          const uint64_t *lens, const int32_t *doc_ids,
                          uint64_t n_changes, int with_meta, int with_seq) {
  std::vector<const uint8_t *> ptrs(n_changes);
  for (uint64_t i = 0; i < n_changes; i++) ptrs[i] = blob + offsets[i];
  return ingest_dispatch(ptrs.data(), lens, doc_ids, n_changes, with_meta,
                         with_seq);
}

#ifdef AM_HAVE_PYTHON
// Zero-copy list ingest: walk a Python list of bytes objects directly
// (no join into a contiguous blob, no per-buffer length array — those
// Python-side passes cost more than the parse itself at fleet scale).
// Each buffer's doc id is its list index (the turbo path's shape).
// MUST be called through ctypes.PyDLL: the pointer/length gather needs
// the GIL, after which the whole batch parse runs with the GIL RELEASED
// (Py_BEGIN_ALLOW_THREADS) so pool workers — and the caller's other
// Python threads — get real cores. The borrowed buffer pointers stay
// valid because the caller holds the list (and its bytes) alive across
// the call. Returns -2 for a non-list / non-bytes item (caller falls
// back to the blob entry), -1 for malformed chunks, row count otherwise.
int64_t am_ingest_changes_list(PyObject *buffers, int with_meta,
                               int with_seq) {
  if (!PyList_Check(buffers)) return -2;
  Py_ssize_t n = PyList_GET_SIZE(buffers);
  std::vector<const uint8_t *> ptrs;
  std::vector<uint64_t> lens;
  ptrs.reserve(size_t(n));
  lens.reserve(size_t(n));
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *it = PyList_GET_ITEM(buffers, i);
    if (!PyBytes_Check(it)) return -2;
    ptrs.push_back(reinterpret_cast<const uint8_t *>(PyBytes_AS_STRING(it)));
    lens.push_back(uint64_t(PyBytes_GET_SIZE(it)));
  }
  int64_t rc;
  Py_BEGIN_ALLOW_THREADS
  rc = ingest_dispatch(ptrs.data(), lens.data(), nullptr, uint64_t(n),
                       with_meta, with_seq);
  Py_END_ALLOW_THREADS
  return rc;
}
#endif  // AM_HAVE_PYTHON

// ---- pool / parse instrumentation exports ---------------------------------

// Monotone ABI stamp, bumped on any C-surface change. The Python wrapper
// refuses to run against a binary whose stamp mismatches (a stale .so
// would otherwise silently run the old single-threaded codec).
int64_t am_abi_version() { return 4; }

int64_t am_pool_configure(int n) { return NativePool::inst().configure(n); }

int64_t am_pool_threads() { return NativePool::inst().threads(); }

int64_t am_pool_stats(int64_t *threads, int64_t *tasks, int64_t *busy_ns) {
  *threads = NativePool::inst().threads();
  *tasks = NativePool::inst().tasks();
  *busy_ns = NativePool::inst().busy_ns();
  return 0;
}

// Per-slice timings of the LAST am_ingest_changes[_list] call, in
// CLOCK_MONOTONIC ns (same epoch as time.perf_counter_ns on Linux).
// rows receives up to cap records of 5 int64s: t0, t1, first_chunk,
// n_chunks, worker. Returns rows written.
int64_t am_ingest_parse_stats(int64_t *wall_t0, int64_t *wall_t1,
                              int64_t *threads, int64_t *rows, int64_t cap) {
  *wall_t0 = g_parse_stats.wall_t0;
  *wall_t1 = g_parse_stats.wall_t1;
  *threads = g_parse_stats.threads;
  int64_t n = int64_t(g_parse_stats.slices.size());
  if (n > cap) n = cap;
  for (int64_t i = 0; i < n; i++) {
    const ParseStats::Slice &s = g_parse_stats.slices[size_t(i)];
    rows[5 * i] = s.t0;
    rows[5 * i + 1] = s.t1;
    rows[5 * i + 2] = s.first;
    rows[5 * i + 3] = s.count;
    rows[5 * i + 4] = s.worker;
  }
  return n;
}

// Copy results out after am_ingest_changes. key_blob receives the interned
// keys as length-prefixed (uleb) strings; returns bytes written or -1 if cap
// too small.
int64_t am_ingest_fetch(int32_t *doc, int32_t *key, int32_t *packed,
                        int32_t *val, uint8_t *flags, uint8_t *key_blob,
                        uint64_t key_blob_cap, int64_t *n_keys,
                        uint8_t *actor_blob, uint64_t actor_blob_cap,
                        int64_t *n_actors) {
  if (!g_ingest) return -1;
  IngestCtx &ctx = *g_ingest;
  size_t n = ctx.out_doc.size();
  copy_bytes(doc, ctx.out_doc.data(), n * 4);
  copy_bytes(key, ctx.out_key.data(), n * 4);
  copy_bytes(packed, ctx.out_packed.data(), n * 4);
  copy_bytes(val, ctx.out_val.data(), n * 4);
  copy_bytes(flags, ctx.out_flags.data(), n);

  auto write_blob = [](const std::vector<std::string> &items, uint8_t *out,
                       uint64_t cap) -> int64_t {
    uint64_t pos = 0;
    for (const auto &s : items) {
      uint64_t len = s.size();
      // uleb encode length
      uint64_t v = len;
      do {
        if (pos >= cap) return -1;
        uint8_t byte = v & 0x7f;
        v >>= 7;
        out[pos++] = byte | (v ? 0x80 : 0);
      } while (v);
      if (pos + len > cap) return -1;
      copy_bytes(out + pos, s.data(), len);
      pos += len;
    }
    return int64_t(pos);
  };
  int64_t kb = write_blob(ctx.keys.items, key_blob, key_blob_cap);
  int64_t ab = write_blob(ctx.actors.items, actor_blob, actor_blob_cap);
  if (kb < 0 || ab < 0) return -1;
  *n_keys = int64_t(ctx.keys.items.size());
  *n_actors = int64_t(ctx.actors.items.size());
  delete g_ingest;
  g_ingest = nullptr;
  return kb;
}

// Bytes used in the actor blob by the last am_ingest_fetch-compatible
// context; callable BEFORE am_ingest_fetch to size slices (returns the
// exact serialized sizes of both blobs as (key_bytes, actor_bytes)).
int64_t am_ingest_blob_sizes(int64_t *key_bytes, int64_t *actor_bytes) {
  if (!g_ingest) return -1;
  IngestCtx &ctx = *g_ingest;
  auto blob_size = [](const std::vector<std::string> &items) -> int64_t {
    uint64_t pos = 0;
    for (const auto &s : items) {
      uint64_t v = s.size();
      do { pos++; v >>= 7; } while (v);
      pos += s.size();
    }
    return int64_t(pos);
  };
  *key_bytes = blob_size(ctx.keys.items);
  *actor_bytes = blob_size(ctx.actors.items);
  return 0;
}

// Exact byte sizes of the pending meta deps/msg blobs so the Python side
// allocates (and copies) only what is used. Must run before am_ingest_fetch.
int64_t am_ingest_meta_sizes(int64_t *deps_bytes, int64_t *msg_bytes) {
  if (!g_ingest) return -1;
  *deps_bytes = int64_t(g_ingest->m_deps.size());
  *msg_bytes = int64_t(g_ingest->m_msg.size());
  return 0;
}

// Copy per-change metadata captured by am_ingest_changes(with_meta=1).
// Must be called BEFORE am_ingest_fetch (which frees the context).
// deps_off/msg_off receive n_changes+1 entries (prefix offsets); deps_blob
// holds 32 bytes per dep. Returns the number of changes, or -1 when the
// context is missing, metadata was not requested, or a blob doesn't fit.
int64_t am_ingest_meta_fetch(int32_t *actor, int64_t *seq, int64_t *start_op,
                             int64_t *time, int64_t *nops, uint8_t *hash32,
                             int64_t *deps_off, uint8_t *deps_blob,
                             uint64_t deps_cap, int64_t *msg_off,
                             uint8_t *msg_blob, uint64_t msg_cap,
                             int64_t *buf_len) {
  if (!g_ingest) return -1;
  IngestCtx &ctx = *g_ingest;
  size_t n = ctx.m_seq.size();
  if (ctx.m_actor.size() != n || ctx.m_nops.size() != n ||
      ctx.m_hash.size() != 32 * n || ctx.m_buf_len.size() != n)
    return -1;
  if (ctx.m_deps.size() > deps_cap || ctx.m_msg.size() > msg_cap) return -1;
  copy_bytes(actor, ctx.m_actor.data(), n * 4);
  copy_bytes(seq, ctx.m_seq.data(), n * 8);
  copy_bytes(start_op, ctx.m_start_op.data(), n * 8);
  copy_bytes(time, ctx.m_time.data(), n * 8);
  copy_bytes(nops, ctx.m_nops.data(), n * 8);
  copy_bytes(hash32, ctx.m_hash.data(), 32 * n);
  copy_bytes(deps_off, ctx.m_deps_off.data(), n * 8);
  deps_off[n] = int64_t(ctx.m_deps.size() / 32);
  copy_bytes(deps_blob, ctx.m_deps.data(), ctx.m_deps.size());
  copy_bytes(msg_off, ctx.m_msg_off.data(), n * 8);
  msg_off[n] = int64_t(ctx.m_msg.size());
  copy_bytes(msg_blob, ctx.m_msg.data(), ctx.m_msg.size());
  copy_bytes(buf_len, ctx.m_buf_len.data(), n * 8);
  return int64_t(n);
}

// ---- batched turbo gate ---------------------------------------------------
//
// The causal-run gate over a whole parsed batch in ONE call, replacing
// the Python side's per-doc hex/dict probes. Operates directly on the
// extractor's hash lanes (hash32 / deps_blob are the am_ingest_meta_fetch
// outputs) plus the fleet's columnar per-doc head lanes (head32:
// n_lanes 32-byte hashes a doc, head_n of them in use, -1 when the
// frontier is wider than the lanes and lives on the host). Called
// through ctypes CDLL, so the GIL is released for the whole scan.
//
// Per doc d (changes are doc-contiguous, doc_off gives the ranges), the
// run is accepted when every dep of every change is one of the doc's
// start heads or an EARLIER change of the same run (buffer order is
// then causal order), and the per-(doc, actor) seqs are contiguous.
// doc_ok[d] says how it was accepted:
//   1  a chain: the first change deps on exactly the start frontier and
//      every later one on exactly the change before it;
//   2  a causal run: anything else the rule above accepts (concurrent
//      branches from the start heads, merges of branches);
//   0  sent to the host's general gate (a dep that is neither, so an
//      out-of-order or unknown dep, or an end frontier past the lanes).
// Docs whose start frontier is wider than the lanes (head_n == -1) are
// held to the chain shape and flagged doc_hostcheck 1: the caller
// compares JUST their first change's deps with the host's head list.
// doc_hostcheck 2 marks a run sent to the host because its end frontier
// would not fit the lanes.
//
// The end frontier of every accepted doc lands in out_head32/out_n: the
// start heads no change of the run depends on, then the run's changes no
// later change depends on, sorted by their bytes (the hex order of the
// host's head lists). A chain's is its last change.
//
// The first seq of each (doc, actor) run is emitted as a group record
// (g_doc/g_actor/g_first/g_last, capacity n_changes) so the caller can
// verify the bases against its clock columns vectorized, and scatter
// g_last back as the clock advance without re-deriving groups.
// Returns the group count, or -1 on out-of-range inputs.
int64_t am_turbo_gate(const int64_t *doc_off, const int32_t *actor,
                      const int64_t *seq, const uint8_t *hash32,
                      const int64_t *deps_off, const uint8_t *deps_blob,
                      const uint8_t *head32, const int32_t *head_n,
                      int64_t n_lanes, int64_t n_docs, int64_t n_changes,
                      int64_t n_actors, uint8_t *doc_ok,
                      uint8_t *doc_hostcheck, uint8_t *out_head32,
                      int32_t *out_n, int32_t *g_doc, int32_t *g_actor,
                      int64_t *g_first, int64_t *g_last) {
  if (n_docs < 0 || n_changes < 0 || n_actors < 0 || n_lanes < 1 ||
      n_lanes > 64)
    return -1;
  // per-actor scratch, epoch-tagged per doc: O(1) reset per document
  std::vector<int32_t> a_epoch(size_t(n_actors), -1);
  std::vector<int64_t> a_last(size_t(n_actors), 0);
  std::vector<int64_t> a_group(size_t(n_actors), 0);
  // has-a-dependent flags: one per change of the batch, one per lane
  std::vector<uint8_t> used(size_t(n_changes), 0);
  std::vector<uint8_t> lane_used(size_t(n_lanes), 0);
  std::vector<const uint8_t *> front;
  int64_t n_groups = 0;
  for (int64_t d = 0; d < n_docs; d++) {
    int64_t lo = doc_off[d], hi = doc_off[d + 1];
    uint8_t ok = 1, chain = 1;
    doc_hostcheck[d] = 0;
    if (lo > hi || lo < 0 || hi > n_changes) return -1;
    int32_t hn = head_n[d];
    if (hn > n_lanes) return -1;
    const uint8_t *lanes = head32 + d * n_lanes * 32;
    if (hn > 0) std::fill(lane_used.begin(), lane_used.begin() + hn, 0);
    for (int64_t i = lo; i < hi && ok; i++) {
      int64_t dc = deps_off[i + 1] - deps_off[i];
      const uint8_t *deps = deps_blob + deps_off[i] * 32;
      if (hn < 0) {
        // wider than the lanes: the chain shape only, first deps on host
        if (i == lo) {
          doc_hostcheck[d] = 1;
        } else if (dc != 1 || memcmp(deps, hash32 + (i - 1) * 32, 32) != 0) {
          ok = 0;
        }
      } else {
        if (i == lo ? dc != hn
                    : dc != 1 || memcmp(deps, hash32 + (i - 1) * 32, 32) != 0)
          chain = 0;
        for (int64_t j = 0; j < dc && ok; j++) {
          const uint8_t *dep = deps + j * 32;
          bool found = false;
          // newest first: a chain's one dep is the change before
          for (int64_t m = i - 1; !found && m >= lo; m--) {
            if (memcmp(dep, hash32 + m * 32, 32) == 0) {
              used[size_t(m)] = 1;
              found = true;
            }
          }
          for (int32_t l = 0; !found && l < hn; l++) {
            if (memcmp(dep, lanes + l * 32, 32) == 0) {
              lane_used[size_t(l)] = 1;
              found = true;
            }
          }
          if (!found) ok = 0;
        }
      }
      int32_t a = actor[i];
      if (a < 0 || a >= n_actors) return -1;
      if (a_epoch[size_t(a)] != int32_t(d)) {
        a_epoch[size_t(a)] = int32_t(d);
        a_group[size_t(a)] = n_groups;
        g_doc[n_groups] = int32_t(d);
        g_actor[n_groups] = a;
        g_first[n_groups] = seq[i];
        g_last[n_groups] = seq[i];
        n_groups++;
      } else {
        if (seq[i] != a_last[size_t(a)] + 1) ok = 0;
        g_last[a_group[size_t(a)]] = seq[i];
      }
      a_last[size_t(a)] = seq[i];
    }
    // the end frontier
    uint8_t *out = out_head32 + d * n_lanes * 32;
    out_n[d] = hn;
    if (ok && hi > lo && hn < 0) {
      memcpy(out, hash32 + (hi - 1) * 32, 32);
      out_n[d] = 1;
    } else if (ok && hi > lo) {
      front.clear();
      for (int32_t l = 0; l < hn; l++)
        if (!lane_used[size_t(l)]) front.push_back(lanes + l * 32);
      for (int64_t i = lo; i < hi; i++)
        if (!used[size_t(i)]) front.push_back(hash32 + i * 32);
      if (int64_t(front.size()) > n_lanes) {
        ok = 0;
        doc_hostcheck[d] = 2;
      } else {
        std::sort(front.begin(), front.end(),
                  [](const uint8_t *x, const uint8_t *y) {
                    return memcmp(x, y, 32) < 0;
                  });
        for (size_t k = 0; k < front.size(); k++)
          memcpy(out + k * 32, front[k], 32);
        out_n[d] = int32_t(front.size());
      }
    } else if (hn > 0) {
      memcpy(out, lanes, size_t(hn) * 32);
    }
    for (int64_t i = lo; i < hi; i++) used[size_t(i)] = 0;
    doc_ok[d] = ok ? (hn < 0 || chain ? 1 : 2) : 0;
  }
  return n_groups;
}

// Copy sequence-op columns captured by am_ingest_changes(with_seq=1).
// Must be called BEFORE am_ingest_fetch (which frees the context).
// Returns row count, or -1 when the context is missing / seq columns were
// not requested (arrays empty while rows exist).
int64_t am_ingest_seq_fetch(int32_t *obj, int32_t *ref, uint8_t *vtype) {
  if (!g_ingest) return -1;
  IngestCtx &ctx = *g_ingest;
  size_t n = ctx.out_obj.size();
  if (n != ctx.out_doc.size() || ctx.out_ref.size() != n ||
      ctx.out_vtype.size() != n)
    return -1;
  copy_bytes(obj, ctx.out_obj.data(), n * 4);
  copy_bytes(ref, ctx.out_ref.data(), n * 4);
  copy_bytes(vtype, ctx.out_vtype.data(), n);
  return int64_t(n);
}

// Number of pred entries captured by the last am_ingest_changes call
// (with_meta=1), so the caller can size the fetch buffer exactly.
// Boxed-value arena size for the pending ingest (with_seq only).
int64_t am_ingest_val_size() {
  return g_ingest ? int64_t(g_ingest->val_arena.size()) : -1;
}

// Copy per-row boxed-value lengths + the raw value arena. Rows with
// vlen == 0 carry inline values (or none); boxed rows' wire bytes
// concatenate in row order. Must run before am_ingest_fetch.
int64_t am_ingest_val_fetch(int32_t *vlen, uint8_t *arena, uint64_t cap) {
  if (!g_ingest) return -1;
  IngestCtx &ctx = *g_ingest;
  if (ctx.out_vlen.size() != ctx.out_doc.size()) return -1;
  if (ctx.val_arena.size() > cap) return -1;
  copy_bytes(vlen, ctx.out_vlen.data(), ctx.out_vlen.size() * 4);
  if (!ctx.val_arena.empty())
    copy_bytes(arena, ctx.val_arena.data(), ctx.val_arena.size());
  return int64_t(ctx.val_arena.size());
}

int64_t am_ingest_pred_count() {
  if (!g_ingest) return -1;
  return int64_t(g_ingest->out_pred.size());
}

// Copy per-op pred lists captured by am_ingest_changes(with_meta=1).
// pred_off receives n_rows+1 prefix offsets. Must be called BEFORE
// am_ingest_fetch (which frees the context). Returns total preds or -1.
int64_t am_ingest_pred_fetch(int64_t *pred_off, int32_t *pred_blob,
                             uint64_t pred_cap) {
  if (!g_ingest) return -1;
  IngestCtx &ctx = *g_ingest;
  size_t n = ctx.out_pred_off.size();
  if (n != ctx.out_doc.size()) return -1;
  if (ctx.out_pred.size() > pred_cap) return -1;
  copy_bytes(pred_off, ctx.out_pred_off.data(), n * 8);
  pred_off[n] = int64_t(ctx.out_pred.size());
  copy_bytes(pred_blob, ctx.out_pred.data(), ctx.out_pred.size() * 4);
  return int64_t(ctx.out_pred.size());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched document-container parse (ref columnar.js:1006-1047): one call
// parses a whole fleet's saved documents straight to flat op/change columns —
// actor tables, heads, change metadata, and document-order op rows with succ
// lists — with NO per-change re-encode or hashing (the deferred-hash-graph
// load of ref new.js:1709-1749). Docs using features outside the flat subset
// (child/link columns, unknown columns, unknown value types, extra bytes)
// get a per-doc ok=0 flag and zero rows; the Python caller routes those
// through the general decode path.
// ---------------------------------------------------------------------------

namespace {

// Known document ops-column ids ((spec << 4) | type; deflate bit 3 cleared)
constexpr int kColIdActor = 0x21, kColIdCtr = 0x23;
constexpr int kColChldActor = 0x61, kColChldCtr = 0x63;
constexpr int kColSuccNum = 0x80, kColSuccActor = 0x81, kColSuccCtr = 0x83;
// Document change-metadata column ids
constexpr int kDocActor = 0x01, kDocSeq = 0x03, kDocMaxOp = 0x13;
constexpr int kDocTime = 0x23, kDocMessage = 0x35;
constexpr int kDocDepsNum = 0x40, kDocDepsIndex = 0x43;
constexpr int kDocExtraLen = 0x56, kDocExtraRaw = 0x57;
constexpr int kDeflateBit = 8;

struct DocParseCtx {
  Interner keys, actors;        // global across the batch
  std::string error;
  // per-doc
  std::vector<uint8_t> d_ok;    // 1 = parsed; 0 = caller falls back
  std::vector<int64_t> d_n_changes, d_n_ops, d_max_op, d_heads_off;
  std::vector<int64_t> d_actor_off;   // into d_actor_ids
  std::vector<int32_t> d_actor_ids;   // per-doc actor table (global ids)
  std::vector<uint8_t> heads;         // 32 bytes per head, concatenated
  // per-change (flat, doc-major)
  std::vector<int32_t> c_doc, c_actor;
  std::vector<int64_t> c_seq, c_max_op;
  // per-op (flat, doc-major, document order)
  std::vector<int32_t> o_doc;
  std::vector<int64_t> o_obj_ctr;     // 0 = root object
  std::vector<int32_t> o_obj_actor;   // global id; -1 = root
  std::vector<int64_t> o_key_ctr;     // elemId counter; 0 = _head/none
  std::vector<int32_t> o_key_actor;   // global id; -1 = none
  std::vector<int32_t> o_key_str;     // interned key; -1 = none (seq op)
  std::vector<uint8_t> o_insert, o_action, o_vtype;
  std::vector<int64_t> o_id_ctr;
  std::vector<int32_t> o_id_actor;    // global id
  std::vector<int64_t> o_val_int;     // int-family value / single codepoint
  std::vector<int64_t> o_val_off;     // into val_blob
  std::vector<int32_t> o_val_len;
  std::vector<uint8_t> val_blob;      // raw value bytes (strings/doubles/...)
  std::vector<int64_t> o_succ_off;    // per op, start index into s_*
  std::vector<int64_t> s_ctr;
  std::vector<int32_t> s_actor;       // global ids
};

static DocParseCtx *g_docparse = nullptr;

// Inflate a raw-DEFLATE column of unknown decompressed size.
static bool inflate_vec(const uint8_t *data, uint64_t len,
                        std::vector<uint8_t> &out) {
  out.clear();
  out.resize(len * 4 + 64);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t *>(data);
  zs.avail_in = uInt(len);
  size_t written = 0;
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    if (written == out.size()) out.resize(out.size() * 2);
    zs.next_out = out.data() + written;
    zs.avail_out = uInt(out.size() - written);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) { inflateEnd(&zs); return false; }
    written = out.size() - zs.avail_out;
    if (ret == Z_OK && zs.avail_in == 0 && zs.avail_out != 0) break;
  }
  inflateEnd(&zs);
  out.resize(written);
  return true;
}

struct DocColumn {
  uint32_t id = 0;
  const uint8_t *buf = nullptr;
  uint64_t len = 0;
  std::vector<uint8_t> inflated;  // backing storage when deflated
};

// Parse one document chunk into ctx; returns false (after truncating any
// partial rows) when the doc needs the general Python path.
static bool parse_document_body(DocParseCtx &ctx, const uint8_t *chunk,
                                uint64_t chunk_len, int32_t doc) {
  Cursor c{chunk, chunk_len};
  const uint8_t *magic = c.bytes(4);
  if (c.fail || memcmp(magic, "\x85\x6f\x4a\x83", 4) != 0) return false;
  const uint8_t *checksum = c.bytes(4);
  uint64_t hash_start = c.pos;
  if (c.fail || c.pos >= chunk_len) return false;
  uint8_t chunk_type = chunk[c.pos];
  c.skip(1);
  uint64_t body_len = c.uleb();
  if (c.fail || chunk_type != 0) return false;
  const uint8_t *body = c.bytes(body_len);
  if (c.fail || c.pos != chunk_len) return false;  // trailing data
  uint8_t digest[32];
  {
    Sha256Stream s;
    sha256_stream_init(s);
    sha256_stream_update(s, chunk + hash_start, c.pos - hash_start);
    sha256_stream_final(s, digest);
  }
  if (memcmp(digest, checksum, 4) != 0) return false;

  Cursor b{body, body_len};
  // Actor table
  uint64_t n_actors = b.uleb();
  std::vector<int32_t> local_actors;
  for (uint64_t i = 0; i < n_actors && !b.fail; i++) {
    uint64_t alen = b.uleb();
    const uint8_t *raw = b.bytes(alen);
    if (b.fail) return false;
    static const char *hex = "0123456789abcdef";
    std::string actor_hex;
    actor_hex.reserve(alen * 2);
    for (uint64_t j = 0; j < alen; j++) {
      actor_hex.push_back(hex[raw[j] >> 4]);
      actor_hex.push_back(hex[raw[j] & 15]);
    }
    local_actors.push_back(ctx.actors.intern(actor_hex));
  }
  if (b.fail) return false;
  // Heads
  uint64_t n_heads = b.uleb();
  if (b.fail) return false;
  size_t heads_start = ctx.heads.size();
  for (uint64_t i = 0; i < n_heads; i++) {
    const uint8_t *h = b.bytes(32);
    if (b.fail) { ctx.heads.resize(heads_start); return false; }
    ctx.heads.insert(ctx.heads.end(), h, h + 32);
  }
  auto bail = [&]() { ctx.heads.resize(heads_start); return false; };

  // Column info tables (ids ascending; only non-empty columns present)
  auto read_col_info = [&](std::vector<DocColumn> &cols) -> bool {
    uint64_t n = b.uleb();
    if (b.fail) return false;
    for (uint64_t i = 0; i < n; i++) {
      DocColumn col;
      col.id = uint32_t(b.uleb());
      col.len = b.uleb();
      if (b.fail) return false;
      cols.push_back(col);
    }
    return true;
  };
  std::vector<DocColumn> ccols, ocols;
  if (!read_col_info(ccols) || !read_col_info(ocols)) return bail();
  for (auto *cols : {&ccols, &ocols}) {
    for (auto &col : *cols) {
      col.buf = b.bytes(col.len);
      if (b.fail) return bail();
      if (col.id & kDeflateBit) {
        if (!inflate_vec(col.buf, col.len, col.inflated)) return bail();
        col.id &= ~uint32_t(kDeflateBit);
        col.buf = col.inflated.data();
        col.len = col.inflated.size();
      }
    }
  }
  // headsIndexes (n_heads ulebs, optional) then extraBytes; any non-empty
  // extraBytes must be preserved -> general path
  if (b.pos < b.len) {
    for (uint64_t i = 0; i < n_heads; i++) b.uleb();
    if (b.fail || b.pos != b.len) return bail();
  }

  auto find = [](std::vector<DocColumn> &cols, uint32_t id) -> DocColumn * {
    for (auto &col : cols) if (col.id == id) return &col;
    return nullptr;
  };

  // ---- change metadata: actor / seq / maxOp (rest lazily via Python) ----
  for (auto &col : ccols) {
    switch (col.id) {
      case kDocActor: case kDocSeq: case kDocMaxOp: case kDocTime:
      case kDocMessage: case kDocDepsNum: case kDocDepsIndex:
      case kDocExtraLen: case kDocExtraRaw:
        break;
      default:
        return bail();      // unknown change-meta column
    }
  }
  std::vector<int64_t> cm_actor, cm_seq, cm_maxop;
  std::vector<uint8_t> m1, m2, m3;
  DocColumn *col_a = find(ccols, kDocActor);
  DocColumn *col_s = find(ccols, kDocSeq);
  DocColumn *col_m = find(ccols, kDocMaxOp);
  if (col_a && !decode_i64_col(col_a->buf, col_a->len, false, false,
                               cm_actor, m1))
    return bail();
  if (col_s && !decode_i64_col(col_s->buf, col_s->len, false, true,
                               cm_seq, m2))
    return bail();
  if (col_m && !decode_i64_col(col_m->buf, col_m->len, false, true,
                               cm_maxop, m3))
    return bail();
  size_t n_changes = cm_actor.size();
  if (cm_seq.size() != n_changes || cm_maxop.size() != n_changes)
    return bail();
  for (size_t i = 0; i < n_changes; i++) {
    if (!m1[i] || !m2[i] || !m3[i]) return bail();
    if (cm_actor[i] < 0 || uint64_t(cm_actor[i]) >= local_actors.size())
      return bail();
  }

  // ---- ops columns ----
  for (auto &col : ocols) {
    switch (col.id) {
      case kColObjActor: case kColObjCtr: case kColKeyActor: case kColKeyCtr:
      case kColKeyStr: case kColIdActor: case kColIdCtr: case kColInsert:
      case kColAction: case kColValLen: case kColValRaw:
      case kColSuccNum: case kColSuccActor: case kColSuccCtr:
        break;
      case kColChldActor: case kColChldCtr:
        if (col.len > 0) return bail();  // child/link ops: general path
        break;
      default:
        return bail();      // unknown ops column: must be preserved
    }
  }
  auto dec = [&](uint32_t id, bool is_signed, bool is_delta,
                 std::vector<int64_t> &vals, std::vector<uint8_t> &mask) {
    DocColumn *col = find(ocols, id);
    if (!col) { vals.clear(); mask.clear(); return true; }
    return decode_i64_col(col->buf, col->len, is_signed, is_delta, vals,
                          mask);
  };
  std::vector<int64_t> obj_actor, obj_ctr, key_actor, key_ctr, id_actor,
      id_ctr, insert_v, action_v, val_len, succ_num, succ_actor, succ_ctr;
  std::vector<uint8_t> obj_actor_m, obj_ctr_m, key_actor_m, key_ctr_m,
      id_actor_m, id_ctr_m, insert_m, action_m, val_len_m, succ_num_m,
      succ_actor_m, succ_ctr_m;
  if (!dec(kColObjActor, false, false, obj_actor, obj_actor_m)) return bail();
  if (!dec(kColObjCtr, false, false, obj_ctr, obj_ctr_m)) return bail();
  if (!dec(kColKeyActor, false, false, key_actor, key_actor_m)) return bail();
  if (!dec(kColKeyCtr, false, true, key_ctr, key_ctr_m)) return bail();
  if (!dec(kColIdActor, false, false, id_actor, id_actor_m)) return bail();
  if (!dec(kColIdCtr, false, true, id_ctr, id_ctr_m)) return bail();
  if (!dec(kColAction, false, false, action_v, action_m)) return bail();
  if (!dec(kColValLen, false, false, val_len, val_len_m)) return bail();
  if (!dec(kColSuccNum, false, false, succ_num, succ_num_m)) return bail();
  if (!dec(kColSuccActor, false, false, succ_actor, succ_actor_m))
    return bail();
  if (!dec(kColSuccCtr, false, true, succ_ctr, succ_ctr_m)) return bail();
  size_t n_ops = id_ctr.size();
  if (id_actor.size() != n_ops || action_v.size() != n_ops) return bail();
  {
    DocColumn *col = find(ocols, kColInsert);
    insert_v.resize(n_ops);
    insert_m.resize(n_ops);
    if (col) {
      int64_t n = am_decode_boolean(col->buf, col->len, insert_v.data(),
                                    insert_m.data(), int64_t(n_ops));
      if (n != int64_t(n_ops)) return bail();
    } else if (n_ops) {
      return bail();
    }
  }
  // keyStr: interned string ids, -1 for null rows
  std::vector<int32_t> key_str;
  {
    DocColumn *col = find(ocols, kColKeyStr);
    if (col) {
      if (!decode_keystr(col->buf, col->len, ctx.keys, key_str))
        return bail();
      if (key_str.size() != n_ops) return bail();
    } else {
      key_str.assign(n_ops, -1);
    }
  }
  // Columns that can be all-null (absent): size them as null rows
  auto pad_null = [&](std::vector<int64_t> &vals, std::vector<uint8_t> &mask) {
    if (vals.empty()) { vals.assign(n_ops, 0); mask.assign(n_ops, 0); }
    return vals.size() == n_ops;
  };
  if (!pad_null(obj_actor, obj_actor_m) || !pad_null(obj_ctr, obj_ctr_m) ||
      !pad_null(key_actor, key_actor_m) || !pad_null(key_ctr, key_ctr_m) ||
      !pad_null(val_len, val_len_m) || !pad_null(succ_num, succ_num_m))
    return bail();
  // succ group: total entries must match the sum of succNum
  uint64_t succ_total = 0;
  for (size_t i = 0; i < n_ops; i++)
    succ_total += succ_num_m[i] ? uint64_t(succ_num[i]) : 0;
  if (succ_actor.size() != succ_total || succ_ctr.size() != succ_total)
    return bail();
  DocColumn *vraw = find(ocols, kColValRaw);
  const uint8_t *raw_buf = vraw ? vraw->buf : nullptr;
  uint64_t raw_len = vraw ? vraw->len : 0;

  // ---- emit rows (rollback on any failure) ----
  size_t ops_start = ctx.o_doc.size();
  size_t succ_start = ctx.s_ctr.size();
  size_t val_start = ctx.val_blob.size();
  auto bail_rows = [&]() {
    ctx.o_doc.resize(ops_start);
    ctx.o_obj_ctr.resize(ops_start);
    ctx.o_obj_actor.resize(ops_start);
    ctx.o_key_ctr.resize(ops_start);
    ctx.o_key_actor.resize(ops_start);
    ctx.o_key_str.resize(ops_start);
    ctx.o_insert.resize(ops_start);
    ctx.o_action.resize(ops_start);
    ctx.o_vtype.resize(ops_start);
    ctx.o_id_ctr.resize(ops_start);
    ctx.o_id_actor.resize(ops_start);
    ctx.o_val_int.resize(ops_start);
    ctx.o_val_off.resize(ops_start);
    ctx.o_val_len.resize(ops_start);
    ctx.o_succ_off.resize(ops_start);
    ctx.s_ctr.resize(succ_start);
    ctx.s_actor.resize(succ_start);
    ctx.val_blob.resize(val_start);
    return bail();
  };
  uint64_t raw_pos = 0;
  uint64_t succ_pos = 0;
  for (size_t i = 0; i < n_ops; i++) {
    if (!id_actor_m[i] || !id_ctr_m[i] || !action_m[i]) return bail_rows();
    int64_t action = action_v[i];
    if (action < 0 || action > 6 || action == 3) return bail_rows();
    // (action 3 = del: documents never store del rows, columnar.js:892;
    //  action 7 = link and anything higher: general path)
    if (uint64_t(id_actor[i]) >= local_actors.size()) return bail_rows();
    if (obj_actor_m[i] != obj_ctr_m[i]) return bail_rows();
    if (obj_actor_m[i] && uint64_t(obj_actor[i]) >= local_actors.size())
      return bail_rows();
    if (key_actor_m[i] && uint64_t(key_actor[i]) >= local_actors.size())
      return bail_rows();
    // elemId columns must be consistent: a non-zero keyCtr needs its actor
    // (keyCtr==0 with null actor is the legal _head encoding), and an
    // actor without a counter is malformed — aliasing either to actor 0
    // would target the wrong element
    if (key_ctr_m[i] && !key_actor_m[i] && key_ctr[i] != 0)
      return bail_rows();
    if (key_actor_m[i] && !key_ctr_m[i]) return bail_rows();
    // value
    uint8_t vtype = 0;
    int64_t vint = 0, voff = 0;
    int32_t vlen = 0;
    if (val_len_m[i]) {
      uint64_t tag = uint64_t(val_len[i]);
      vtype = uint8_t(tag & 0xf);
      vlen = int32_t(tag >> 4);
      if (vtype >= 10) return bail_rows();      // unknown value types
      if (raw_pos + uint64_t(vlen) > raw_len) return bail_rows();
      voff = int64_t(ctx.val_blob.size());
      ctx.val_blob.insert(ctx.val_blob.end(), raw_buf + raw_pos,
                          raw_buf + raw_pos + vlen);
      if (vtype == 3 || vtype == 4 || vtype == 8 || vtype == 9) {
        uint64_t p = 0;
        int err = 0;
        vint = (vtype == 3)
            ? int64_t(read_uleb(raw_buf + raw_pos, vlen, &p, &err))
            : read_sleb(raw_buf + raw_pos, vlen, &p, &err);
        if (err || p != uint64_t(vlen)) return bail_rows();
      } else if (vtype == 6) {
        vint = utf8_single_cp(raw_buf + raw_pos, vlen);  // -1 = multi-char
      }
      raw_pos += uint64_t(vlen);
    }
    ctx.o_doc.push_back(doc);
    ctx.o_obj_ctr.push_back(obj_ctr_m[i] ? obj_ctr[i] : 0);
    ctx.o_obj_actor.push_back(
        obj_actor_m[i] ? local_actors[size_t(obj_actor[i])] : -1);
    ctx.o_key_ctr.push_back(key_ctr_m[i] ? key_ctr[i] : 0);
    ctx.o_key_actor.push_back(
        key_actor_m[i] ? local_actors[size_t(key_actor[i])] : -1);
    ctx.o_key_str.push_back(key_str[i]);
    ctx.o_insert.push_back(uint8_t(insert_m[i] ? insert_v[i] : 0));
    ctx.o_action.push_back(uint8_t(action));
    ctx.o_vtype.push_back(vtype);
    ctx.o_id_ctr.push_back(id_ctr[i]);
    ctx.o_id_actor.push_back(local_actors[size_t(id_actor[i])]);
    ctx.o_val_int.push_back(vint);
    ctx.o_val_off.push_back(voff);
    ctx.o_val_len.push_back(vlen);
    ctx.o_succ_off.push_back(int64_t(succ_start + succ_pos));
    uint64_t num = succ_num_m[i] ? uint64_t(succ_num[i]) : 0;
    for (uint64_t k = 0; k < num; k++, succ_pos++) {
      if (!succ_actor_m[succ_pos] || !succ_ctr_m[succ_pos])
        return bail_rows();
      if (uint64_t(succ_actor[succ_pos]) >= local_actors.size())
        return bail_rows();
      ctx.s_ctr.push_back(succ_ctr[succ_pos]);
      ctx.s_actor.push_back(local_actors[size_t(succ_actor[succ_pos])]);
    }
  }
  if (raw_pos != raw_len || succ_pos != succ_total) return bail_rows();

  // ---- commit per-doc/per-change metadata ----
  int64_t max_op = 0;
  for (size_t i = 0; i < n_changes; i++) {
    ctx.c_doc.push_back(doc);
    ctx.c_actor.push_back(local_actors[size_t(cm_actor[i])]);
    ctx.c_seq.push_back(cm_seq[i]);
    ctx.c_max_op.push_back(cm_maxop[i]);
    if (cm_maxop[i] > max_op) max_op = cm_maxop[i];
  }
  ctx.d_n_changes.push_back(int64_t(n_changes));
  ctx.d_n_ops.push_back(int64_t(n_ops));
  ctx.d_max_op.push_back(max_op);
  ctx.d_heads_off.push_back(int64_t(heads_start / 32));
  ctx.d_actor_off.push_back(int64_t(ctx.d_actor_ids.size()));
  ctx.d_actor_ids.insert(ctx.d_actor_ids.end(), local_actors.begin(),
                         local_actors.end());
  return true;
}

}  // namespace

extern "C" {

// Parse a batch of document chunks. Returns total op rows across parsed
// docs, or -1 on allocation-level failure. Per-doc failures set ok=0 and
// contribute no rows (the caller falls back per doc).
int64_t am_parse_documents(const uint8_t *blob, const uint64_t *offsets,
                           const uint64_t *lens, uint64_t n_docs) {
  delete g_docparse;
  g_docparse = new DocParseCtx();
  DocParseCtx &ctx = *g_docparse;
  for (uint64_t d = 0; d < n_docs; d++) {
    size_t nc = ctx.c_doc.size();
    bool ok = parse_document_body(ctx, blob + offsets[d], lens[d],
                                  int32_t(d));
    if (!ok) {
      // parse_document_body rolls back rows/heads; change meta may remain
      ctx.c_doc.resize(nc);
      ctx.c_actor.resize(nc);
      ctx.c_seq.resize(nc);
      ctx.c_max_op.resize(nc);
      ctx.d_ok.push_back(0);
      ctx.d_n_changes.push_back(0);
      ctx.d_n_ops.push_back(0);
      ctx.d_max_op.push_back(0);
      ctx.d_heads_off.push_back(int64_t(ctx.heads.size() / 32));
      ctx.d_actor_off.push_back(int64_t(ctx.d_actor_ids.size()));
    } else {
      ctx.d_ok.push_back(1);
    }
  }
  return int64_t(ctx.o_doc.size());
}

// Sizes needed to allocate fetch buffers. Returns 0, or -1 with no context.
int64_t am_docparse_sizes(int64_t *n_changes, int64_t *n_succ,
                          int64_t *n_heads, int64_t *val_bytes,
                          int64_t *actor_blob_bytes, int64_t *n_actors,
                          int64_t *key_blob_bytes, int64_t *n_keys,
                          int64_t *n_doc_actors) {
  if (!g_docparse) return -1;
  DocParseCtx &ctx = *g_docparse;
  auto blob_size = [](const std::vector<std::string> &items) -> int64_t {
    uint64_t pos = 0;
    for (const auto &s : items) {
      uint64_t v = s.size();
      do { pos++; v >>= 7; } while (v);
      pos += s.size();
    }
    return int64_t(pos);
  };
  *n_changes = int64_t(ctx.c_doc.size());
  *n_succ = int64_t(ctx.s_ctr.size());
  *n_heads = int64_t(ctx.heads.size() / 32);
  *val_bytes = int64_t(ctx.val_blob.size());
  *actor_blob_bytes = blob_size(ctx.actors.items);
  *n_actors = int64_t(ctx.actors.items.size());
  *key_blob_bytes = blob_size(ctx.keys.items);
  *n_keys = int64_t(ctx.keys.items.size());
  *n_doc_actors = int64_t(ctx.d_actor_ids.size());
  return 0;
}

// Copy out every parsed array. Array sizes follow am_parse_documents'
// return (n_ops) and am_docparse_sizes. Frees the context on success.
int64_t am_docparse_fetch(
    uint8_t *d_ok, int64_t *d_n_changes, int64_t *d_n_ops, int64_t *d_max_op,
    int64_t *d_heads_off, int64_t *d_actor_off, int32_t *d_actor_ids,
    uint8_t *heads,
    int32_t *c_doc, int32_t *c_actor, int64_t *c_seq, int64_t *c_max_op,
    int32_t *o_doc, int64_t *o_obj_ctr, int32_t *o_obj_actor,
    int64_t *o_key_ctr, int32_t *o_key_actor, int32_t *o_key_str,
    uint8_t *o_insert, uint8_t *o_action, uint8_t *o_vtype,
    int64_t *o_id_ctr, int32_t *o_id_actor,
    int64_t *o_val_int, int64_t *o_val_off, int32_t *o_val_len,
    uint8_t *val_blob, int64_t *o_succ_off, int64_t *s_ctr, int32_t *s_actor,
    uint8_t *key_blob, uint64_t key_blob_cap,
    uint8_t *actor_blob, uint64_t actor_blob_cap) {
  if (!g_docparse) return -1;
  DocParseCtx &ctx = *g_docparse;
  size_t nd = ctx.d_ok.size(), nc = ctx.c_doc.size(), no = ctx.o_doc.size();
  copy_bytes(d_ok, ctx.d_ok.data(), nd);
  copy_bytes(d_n_changes, ctx.d_n_changes.data(), nd * 8);
  copy_bytes(d_n_ops, ctx.d_n_ops.data(), nd * 8);
  copy_bytes(d_max_op, ctx.d_max_op.data(), nd * 8);
  copy_bytes(d_heads_off, ctx.d_heads_off.data(), nd * 8);
  d_heads_off[nd] = int64_t(ctx.heads.size() / 32);
  copy_bytes(d_actor_off, ctx.d_actor_off.data(), nd * 8);
  d_actor_off[nd] = int64_t(ctx.d_actor_ids.size());
  copy_bytes(d_actor_ids, ctx.d_actor_ids.data(), ctx.d_actor_ids.size() * 4);
  copy_bytes(heads, ctx.heads.data(), ctx.heads.size());
  copy_bytes(c_doc, ctx.c_doc.data(), nc * 4);
  copy_bytes(c_actor, ctx.c_actor.data(), nc * 4);
  copy_bytes(c_seq, ctx.c_seq.data(), nc * 8);
  copy_bytes(c_max_op, ctx.c_max_op.data(), nc * 8);
  copy_bytes(o_doc, ctx.o_doc.data(), no * 4);
  copy_bytes(o_obj_ctr, ctx.o_obj_ctr.data(), no * 8);
  copy_bytes(o_obj_actor, ctx.o_obj_actor.data(), no * 4);
  copy_bytes(o_key_ctr, ctx.o_key_ctr.data(), no * 8);
  copy_bytes(o_key_actor, ctx.o_key_actor.data(), no * 4);
  copy_bytes(o_key_str, ctx.o_key_str.data(), no * 4);
  copy_bytes(o_insert, ctx.o_insert.data(), no);
  copy_bytes(o_action, ctx.o_action.data(), no);
  copy_bytes(o_vtype, ctx.o_vtype.data(), no);
  copy_bytes(o_id_ctr, ctx.o_id_ctr.data(), no * 8);
  copy_bytes(o_id_actor, ctx.o_id_actor.data(), no * 4);
  copy_bytes(o_val_int, ctx.o_val_int.data(), no * 8);
  copy_bytes(o_val_off, ctx.o_val_off.data(), no * 8);
  copy_bytes(o_val_len, ctx.o_val_len.data(), no * 4);
  copy_bytes(val_blob, ctx.val_blob.data(), ctx.val_blob.size());
  copy_bytes(o_succ_off, ctx.o_succ_off.data(), no * 8);
  o_succ_off[no] = int64_t(ctx.s_ctr.size());
  copy_bytes(s_ctr, ctx.s_ctr.data(), ctx.s_ctr.size() * 8);
  copy_bytes(s_actor, ctx.s_actor.data(), ctx.s_actor.size() * 4);

  auto write_blob = [](const std::vector<std::string> &items, uint8_t *out,
                       uint64_t cap) -> int64_t {
    uint64_t pos = 0;
    for (const auto &s : items) {
      uint64_t len = s.size();
      uint64_t v = len;
      do {
        if (pos >= cap) return -1;
        uint8_t byte = v & 0x7f;
        v >>= 7;
        out[pos++] = byte | (v ? 0x80 : 0);
      } while (v);
      if (pos + len > cap) return -1;
      copy_bytes(out + pos, s.data(), len);
      pos += len;
    }
    return int64_t(pos);
  };
  if (write_blob(ctx.keys.items, key_blob, key_blob_cap) < 0) return -1;
  if (write_blob(ctx.actors.items, actor_blob, actor_blob_cap) < 0) return -1;
  delete g_docparse;
  g_docparse = nullptr;
  return int64_t(no);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native document builder: change log -> canonical document container
// (the mirror-free save of round-2 VERDICT item 8). Parses the engine's
// binary changes (full op coverage), replays them into a succ-annotated op
// store (the visibility model of ref new.js:1204-1217, RGA insertion of
// new.js:145-163), and serializes the document chunk (ref
// columnar.js:983-1004) with the same canonical change order and byte-exact
// column encodings as the host engine's save() — no host mirror, no Python
// per-op work. Bails (caller falls back to the Python path) on link/child
// ops, unknown columns, or malformed histories.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <list>
#include <map>
#include <queue>

namespace {

// ---- byte-exact column encoders (mirroring automerge_tpu/encoding.py) ----

struct ByteBuf {
  std::vector<uint8_t> b;
  void u8(uint8_t v) { b.push_back(v); }
  void uleb(uint64_t v) {
    do {
      uint8_t byte = v & 0x7f;
      v >>= 7;
      b.push_back(byte | (v ? 0x80 : 0));
    } while (v);
  }
  void sleb(int64_t v) {
    bool more = true;
    while (more) {
      uint8_t byte = v & 0x7f;
      v >>= 7;
      if ((v == 0 && !(byte & 0x40)) || (v == -1 && (byte & 0x40)))
        more = false;
      b.push_back(byte | (more ? 0x80 : 0));
    }
  }
  void raw(const uint8_t *p, size_t n) { b.insert(b.end(), p, p + n); }
  void prefixed(const std::string &s) {
    uleb(s.size());
    raw((const uint8_t *)s.data(), s.size());
  }
};

// RLE encoder over int64 values (uint/int wire flavors) or strings, with
// nulls; exact state machine of encoding.py RLEEncoder.
struct RleEnc {
  enum Type { UINT, INT, UTF8 } type;
  enum State { EMPTY, LONE, REP, LIT, NULLS } state = EMPTY;
  ByteBuf out;
  int64_t last_i = 0;
  std::string last_s;
  bool last_null = false;
  uint64_t count = 0;
  std::vector<std::pair<int64_t, std::string>> literal;

  explicit RleEnc(Type t) : type(t) {}

  void raw_value(int64_t vi, const std::string &vs) {
    if (type == UINT) out.uleb(uint64_t(vi));
    else if (type == INT) out.sleb(vi);
    else out.prefixed(vs);
  }
  bool eq_last(bool is_null, int64_t vi, const std::string &vs) const {
    if (last_null || is_null) return last_null == is_null;
    return type == UTF8 ? last_s == vs : last_i == vi;
  }
  void set_last(bool is_null, int64_t vi, const std::string &vs) {
    last_null = is_null;
    last_i = vi;
    last_s = vs;
  }
  void flush() {
    if (state == LONE) {
      out.sleb(-1);
      raw_value(last_i, last_s);
    } else if (state == REP) {
      out.sleb(int64_t(count));
      raw_value(last_i, last_s);
    } else if (state == LIT) {
      out.sleb(-int64_t(literal.size()));
      for (auto &v : literal) raw_value(v.first, v.second);
      literal.clear();
    } else if (state == NULLS) {
      out.sleb(0);
      out.uleb(count);
    }
    state = EMPTY;
  }
  void append(bool is_null, int64_t vi, const std::string &vs,
              uint64_t reps = 1) {
    if (reps == 0) return;
    if (state == EMPTY) {
      state = is_null ? NULLS : (reps == 1 ? LONE : REP);
      set_last(is_null, vi, vs);
      count = reps;
    } else if (state == LONE) {
      if (is_null) {
        flush(); state = NULLS; count = reps;
      } else if (eq_last(false, vi, vs)) {
        state = REP; count = 1 + reps;
      } else if (reps > 1) {
        flush(); state = REP; count = reps; set_last(false, vi, vs);
      } else {
        state = LIT;
        literal.clear();
        literal.emplace_back(last_i, last_s);
        set_last(false, vi, vs);
      }
    } else if (state == REP) {
      if (is_null) {
        flush(); state = NULLS; count = reps;
      } else if (eq_last(false, vi, vs)) {
        count += reps;
      } else if (reps > 1) {
        flush(); state = REP; count = reps; set_last(false, vi, vs);
      } else {
        flush(); state = LONE; set_last(false, vi, vs);
      }
    } else if (state == LIT) {
      if (is_null) {
        literal.emplace_back(last_i, last_s);
        flush(); state = NULLS; count = reps;
      } else if (eq_last(false, vi, vs)) {
        flush(); state = REP; count = 1 + reps;
      } else if (reps > 1) {
        literal.emplace_back(last_i, last_s);
        flush(); state = REP; count = reps; set_last(false, vi, vs);
      } else {
        literal.emplace_back(last_i, last_s);
        set_last(false, vi, vs);
      }
    } else {  // NULLS
      if (is_null) {
        count += reps;
      } else if (reps > 1) {
        flush(); state = REP; count = reps; set_last(false, vi, vs);
      } else {
        flush(); state = LONE; set_last(false, vi, vs);
      }
    }
  }
  void value(int64_t v) { append(false, v, std::string()); }
  void str(const std::string &s) { append(false, 0, s); }
  void null_() { append(true, 0, std::string()); }
  void finish() {
    if (state == LIT) literal.emplace_back(last_i, last_s);
    // an all-null sequence encodes to nothing (encoding.py finish)
    if (state != NULLS || !out.b.empty()) flush();
  }
};

// Delta encoder: RLE('int') over successive differences (encoding.py).
struct DeltaEnc {
  RleEnc rle{RleEnc::INT};
  int64_t absolute = 0;
  void value(int64_t v) {
    rle.append(false, v - absolute, std::string());
    absolute = v;
  }
  void null_() { rle.null_(); }
  void finish() { rle.finish(); }
};

// Boolean encoder: alternating false/true run lengths starting with false.
struct BoolEnc {
  ByteBuf out;
  bool last = false;
  uint64_t count = 0;
  void value(bool v) {
    if (last == v) {
      count++;
    } else {
      out.uleb(count);
      last = v;
      count = 1;
    }
  }
  void finish() {
    if (count > 0) {
      out.uleb(count);
      count = 0;
    }
  }
};

// ---- parsed change / op store --------------------------------------------

struct BOp {
  int64_t ctr;                 // own opId counter
  int32_t actor;               // own actor (doc-table number, hex-sorted)
  uint8_t action;              // wire action 0..6
  uint8_t insert;
  int8_t key_kind;             // 0 = map key, 1 = _head, 2 = elemId
  std::string key;             // map key (utf8)
  int64_t ek_ctr = 0;          // elemId ref (insert: original referent;
  int32_t ek_actor = -1;       //  update: target element)
  int64_t obj_ctr = 0;         // containing object (0/-1 = root)
  int32_t obj_actor = -1;
  uint32_t vtag = 0;           // valLen tag (len<<4 | type)
  uint64_t voff = 0;           // into BuildCtx::vals
  std::vector<std::pair<int64_t, int32_t>> pred;
};

struct BChange {
  std::string actor_hex;
  int32_t actor = 0;
  uint64_t seq = 0, start_op = 0;
  int64_t time = 0;
  std::string message;
  std::vector<std::string> deps;     // dep hashes (hex)
  std::string hash;                  // own hash (hex)
  std::string extra;                 // change-level extra bytes
  std::vector<BOp> ops;
};

struct BRow {
  int64_t ctr;
  int32_t actor;
  uint8_t action;
  uint8_t insert;
  int8_t key_kind;
  int64_t ek_ctr;
  int32_t ek_actor;
  uint32_t vtag;
  uint64_t voff;
  std::vector<std::pair<int64_t, int32_t>> succ;   // kept lamport-sorted
};

struct BElem {
  int64_t ctr;
  int32_t actor;
  std::vector<BRow> rows;
};

struct BObj {
  uint8_t type = 0;              // wire make action; root = 0 (map)
  bool is_seq = false;
  // map keys sorted by UTF-16 code units (op_set._utf16_key)
  std::map<std::u16string, std::vector<BRow>> keys;
  std::map<std::u16string, std::string> key_utf8;
  std::list<BElem> elems;
  std::unordered_map<int64_t, std::list<BElem>::iterator> elem_index;
};

struct BuildCtx {
  std::vector<BChange> changes;
  std::vector<std::string> actors;             // hex-sorted doc actor table
  std::unordered_map<std::string, int32_t> actor_index;
  std::map<std::pair<int64_t, int32_t>, BObj> objects;  // (ctr, actor)
  BObj root;
  std::vector<uint8_t> vals;                   // raw value bytes arena
  std::vector<uint8_t> result;
  std::string error;
};

static bool utf8_to_u16(const std::string &s, std::u16string &out) {
  size_t i = 0;
  out.clear();
  while (i < s.size()) {
    uint8_t b = s[i];
    uint32_t cp;
    size_t need;
    if (b < 0x80) { cp = b; need = 1; }
    else if ((b >> 5) == 6) { cp = b & 0x1f; need = 2; }
    else if ((b >> 4) == 14) { cp = b & 0x0f; need = 3; }
    else if ((b >> 3) == 30) { cp = b & 0x07; need = 4; }
    else return false;
    if (i + need > s.size()) return false;
    for (size_t k = 1; k < need; k++) {
      if ((uint8_t(s[i + k]) >> 6) != 2) return false;
      cp = (cp << 6) | (uint8_t(s[i + k]) & 0x3f);
    }
    i += need;
    if (cp >= 0x10000) {
      cp -= 0x10000;
      out.push_back(char16_t(0xd800 + (cp >> 10)));
      out.push_back(char16_t(0xdc00 + (cp & 0x3ff)));
    } else {
      out.push_back(char16_t(cp));
    }
  }
  return true;
}

static const char *kHex = "0123456789abcdef";

static std::string to_hex(const uint8_t *p, size_t n) {
  std::string s;
  s.reserve(n * 2);
  for (size_t i = 0; i < n; i++) {
    s.push_back(kHex[p[i] >> 4]);
    s.push_back(kHex[p[i] & 15]);
  }
  return s;
}

// Parse one change chunk (full op coverage; link/child/unknown bail).
// Pass 1 (actors_only): just collect the author hex id.
static bool build_parse_change(BuildCtx &ctx, const uint8_t *chunk,
                               uint64_t chunk_len, bool actors_only,
                               std::vector<uint8_t> &inflate_scratch) {
  // container: magic, checksum, type, length
  if (chunk_len < 11) return false;
  if (memcmp(chunk, "\x85\x6f\x4a\x83", 4) != 0) return false;
  uint8_t chunk_type = chunk[8];
  if (chunk_type == 2) {  // deflated change: inflate body, rebuild chunk
    Cursor c{chunk, chunk_len};
    c.skip(9);
    uint64_t blen = c.uleb();
    const uint8_t *body = c.bytes(blen);
    if (c.fail || c.pos != chunk_len) return false;
    std::vector<uint8_t> raw;
    if (!inflate_vec(body, blen, raw)) return false;
    // Reconstruct the uncompressed chunk (magic + original checksum +
    // type 1 + LEB length + inflated body): the change hash is defined
    // over exactly these bytes (columnar.js:688-708). The recursive call
    // sees chunk type 1 and never touches the scratch it is reading from.
    std::vector<uint8_t> rebuilt(chunk, chunk + 8);
    rebuilt.push_back(1);
    uint64_t v = raw.size();
    do {
      uint8_t byte = v & 0x7f;
      v >>= 7;
      rebuilt.push_back(byte | (v ? 0x80 : 0));
    } while (v);
    rebuilt.insert(rebuilt.end(), raw.begin(), raw.end());
    return build_parse_change(ctx, rebuilt.data(), rebuilt.size(),
                              actors_only, inflate_scratch);
  }
  if (chunk_type != 1) return false;
  Cursor c{chunk, chunk_len};
  c.skip(8);
  uint64_t hash_start = c.pos;
  c.skip(1);
  uint64_t body_len = c.uleb();
  const uint8_t *body = c.bytes(body_len);
  if (c.fail || c.pos != chunk_len) return false;

  BChange ch;
  {
    uint8_t digest[32];
    Sha256Stream s;
    sha256_stream_init(s);
    sha256_stream_update(s, chunk + hash_start, c.pos - hash_start);
    sha256_stream_final(s, digest);
    ch.hash = to_hex(digest, 32);
  }

  Cursor b{body, body_len};
  uint64_t n_deps = b.uleb();
  for (uint64_t i = 0; i < n_deps; i++) {
    const uint8_t *h = b.bytes(32);
    if (b.fail) return false;
    ch.deps.push_back(to_hex(h, 32));
  }
  uint64_t alen = b.uleb();
  const uint8_t *araw = b.bytes(alen);
  if (b.fail) return false;
  ch.actor_hex = to_hex(araw, alen);
  ch.seq = b.uleb();
  ch.start_op = b.uleb();
  ch.time = b.sleb();
  uint64_t mlen = b.uleb();
  const uint8_t *mraw = b.bytes(mlen);
  if (b.fail) return false;
  ch.message.assign((const char *)mraw, mlen);
  // other actors referenced by this change's op columns
  std::vector<std::string> chg_actors{ch.actor_hex};
  uint64_t n_more = b.uleb();
  for (uint64_t i = 0; i < n_more; i++) {
    uint64_t l = b.uleb();
    const uint8_t *p = b.bytes(l);
    if (b.fail) return false;
    chg_actors.push_back(to_hex(p, l));
  }
  if (actors_only) {
    ctx.changes.push_back(std::move(ch));
    return true;
  }

  // column info + buffers
  std::vector<DocColumn> cols;
  uint64_t n_cols = b.uleb();
  if (b.fail) return false;
  for (uint64_t i = 0; i < n_cols; i++) {
    DocColumn col;
    col.id = uint32_t(b.uleb());
    col.len = b.uleb();
    if (b.fail) return false;
    cols.push_back(col);
  }
  for (auto &col : cols) {
    col.buf = b.bytes(col.len);
    if (b.fail) return false;
    if (col.id & kDeflateBit) {
      if (!inflate_vec(col.buf, col.len, col.inflated)) return false;
      col.id &= ~uint32_t(kDeflateBit);
      col.buf = col.inflated.data();
      col.len = col.inflated.size();
    }
  }
  if (b.pos != b.len) {
    // change-level extraBytes: preserved through the changes columns
    ch.extra.assign((const char *)(body + b.pos), body_len - b.pos);
  }
  for (auto &col : cols) {
    switch (col.id) {
      case kColObjActor: case kColObjCtr: case kColKeyActor: case kColKeyCtr:
      case kColKeyStr: case kColInsert: case kColAction: case kColValLen:
      case kColValRaw: case kColPredNum: case kColPredActor: case kColPredCtr:
        break;
      case kColChldActor: case kColChldCtr:
        if (col.len > 0) return false;   // link/child ops: Python path
        break;
      default:
        return false;                    // unknown columns: Python path
    }
  }
  auto find = [&](uint32_t id) -> DocColumn * {
    for (auto &col : cols) if (col.id == id) return &col;
    return nullptr;
  };
  auto dec = [&](uint32_t id, bool sgn, bool delta, std::vector<int64_t> &v,
                 std::vector<uint8_t> &m) {
    DocColumn *col = find(id);
    if (!col) { v.clear(); m.clear(); return true; }
    return decode_i64_col(col->buf, col->len, sgn, delta, v, m);
  };
  std::vector<int64_t> obj_a, obj_c, key_a, key_c, act_v, vlen_v, pn, pa, pc;
  std::vector<uint8_t> obj_am, obj_cm, key_am, key_cm, act_m, vlen_m, pnm,
      pam, pcm;
  if (!dec(kColObjActor, false, false, obj_a, obj_am)) return false;
  if (!dec(kColObjCtr, false, false, obj_c, obj_cm)) return false;
  if (!dec(kColKeyActor, false, false, key_a, key_am)) return false;
  if (!dec(kColKeyCtr, false, true, key_c, key_cm)) return false;
  if (!dec(kColAction, false, false, act_v, act_m)) return false;
  if (!dec(kColValLen, false, false, vlen_v, vlen_m)) return false;
  if (!dec(kColPredNum, false, false, pn, pnm)) return false;
  if (!dec(kColPredActor, false, false, pa, pam)) return false;
  if (!dec(kColPredCtr, false, true, pc, pcm)) return false;
  size_t n_ops = act_v.size();
  std::vector<int64_t> ins_v(n_ops);
  std::vector<uint8_t> ins_m(n_ops);
  {
    DocColumn *col = find(kColInsert);
    if (col) {
      if (am_decode_boolean(col->buf, col->len, ins_v.data(), ins_m.data(),
                            int64_t(n_ops)) != int64_t(n_ops))
        return false;
    } else if (n_ops) {
      return false;
    }
  }
  // keyStr: decode to per-op strings (-1 = null)
  std::vector<int32_t> kstr(n_ops, -1);
  Interner local_keys;
  {
    DocColumn *col = find(kColKeyStr);
    if (col) {
      std::vector<int32_t> tmp;
      if (!decode_keystr(col->buf, col->len, local_keys, tmp)) return false;
      if (tmp.size() != n_ops) return false;
      kstr = tmp;
    }
  }
  auto pad = [&](std::vector<int64_t> &v, std::vector<uint8_t> &m) {
    if (v.empty()) { v.assign(n_ops, 0); m.assign(n_ops, 0); }
    return v.size() == n_ops;
  };
  if (!pad(obj_a, obj_am) || !pad(obj_c, obj_cm) || !pad(key_a, key_am) ||
      !pad(key_c, key_cm) || !pad(vlen_v, vlen_m) || !pad(pn, pnm))
    return false;
  uint64_t pred_total = 0;
  for (size_t i = 0; i < n_ops; i++)
    pred_total += pnm[i] ? uint64_t(pn[i]) : 0;
  if (pa.size() != pred_total || pc.size() != pred_total) return false;
  DocColumn *vraw = find(kColValRaw);
  const uint8_t *raw_buf = vraw ? vraw->buf : nullptr;
  uint64_t raw_len = vraw ? vraw->len : 0;

  auto remap = [&](int64_t local) -> int32_t {
    if (local < 0 || uint64_t(local) >= chg_actors.size()) return -1;
    auto it = ctx.actor_index.find(chg_actors[size_t(local)]);
    return it == ctx.actor_index.end() ? -1 : it->second;
  };
  uint64_t raw_pos = 0, pred_pos = 0;
  for (size_t i = 0; i < n_ops; i++) {
    if (!act_m[i]) return false;
    // actions 0..6 only (7 = link and above need the Python path)
    if (act_v[i] < 0 || act_v[i] > 6) return false;
    BOp op;
    op.ctr = int64_t(ch.start_op + i);
    op.actor = remap(0);           // own ops are always by the change actor
    op.action = uint8_t(act_v[i]);
    op.insert = uint8_t(ins_m[i] ? ins_v[i] : 0);
    if (op.actor < 0) return false;
    // object
    if (obj_am[i] != obj_cm[i]) return false;
    if (obj_am[i]) {
      op.obj_ctr = obj_c[i];
      op.obj_actor = remap(obj_a[i]);
      if (op.obj_actor < 0) return false;
    }
    // key
    if (kstr[i] >= 0) {
      if (key_am[i] || (key_cm[i])) return false;
      op.key_kind = 0;
      op.key = local_keys.items[size_t(kstr[i])];
    } else if (key_cm[i] && key_c[i] == 0 && !key_am[i]) {
      op.key_kind = 1;   // _head
    } else if (key_cm[i] && key_am[i]) {
      op.key_kind = 2;
      op.ek_ctr = key_c[i];
      op.ek_actor = remap(key_a[i]);
      if (op.ek_actor < 0) return false;
    } else {
      return false;
    }
    // value
    if (vlen_m[i]) {
      uint64_t tag = uint64_t(vlen_v[i]);
      uint32_t ln = uint32_t(tag >> 4);
      if (raw_pos + ln > raw_len) return false;
      op.vtag = uint32_t(tag);
      op.voff = ctx.vals.size();
      ctx.vals.insert(ctx.vals.end(), raw_buf + raw_pos,
                      raw_buf + raw_pos + ln);
      raw_pos += ln;
    } else {
      op.vtag = 0;       // VALUE_TYPE NULL, zero length
      op.voff = ctx.vals.size();
    }
    // preds
    uint64_t np = pnm[i] ? uint64_t(pn[i]) : 0;
    for (uint64_t k = 0; k < np; k++, pred_pos++) {
      if (!pam[pred_pos] || !pcm[pred_pos]) return false;
      int32_t pactor = remap(pa[pred_pos]);
      if (pactor < 0) return false;
      op.pred.emplace_back(pc[pred_pos], pactor);
    }
    ch.ops.push_back(std::move(op));
  }
  if (raw_pos != raw_len || pred_pos != pred_total) return false;
  ctx.changes.push_back(std::move(ch));
  return true;
}

}  // namespace

namespace {

static inline int64_t elem_key(int64_t ctr, int32_t actor) {
  return (ctr << 8) | int64_t(actor & 0xff);
}

static inline bool lamport_lt(int64_t c1, int32_t a1, int64_t c2,
                              int32_t a2) {
  // actor numbers are hex-sorted doc-table indexes, so (ctr, num) ordering
  // equals the reference's (counter, actorId-string) lamportCompare
  return c1 != c2 ? c1 < c2 : a1 < a2;
}

static BObj *build_resolve_obj(BuildCtx &ctx, int64_t ctr, int32_t actor) {
  if (actor < 0) return &ctx.root;
  auto it = ctx.objects.find({ctr, actor});
  return it == ctx.objects.end() ? nullptr : &it->second;
}

static BRow build_row_from(const BOp &op) {
  BRow r;
  r.ctr = op.ctr;
  r.actor = op.actor;
  r.action = op.action;
  r.insert = op.insert;
  r.key_kind = op.key_kind;
  r.ek_ctr = op.ek_ctr;
  r.ek_actor = op.ek_actor;
  r.vtag = op.vtag;
  r.voff = op.voff;
  return r;
}

// Apply one op to the store (host op_set._apply_op minus patches):
// succ marking on preds, lamport-sorted row insertion, RGA element splice
// with the concurrent-insert skip (ref new.js:145-163, :1204-1217).
static bool build_apply_op(BuildCtx &ctx, const BOp &op, std::string &key16buf) {
  if (op.action == 0 || op.action == 2 || op.action == 4 || op.action == 6) {
    BObj obj;
    obj.type = op.action;
    obj.is_seq = (op.action == 2 || op.action == 4);
    auto ins = ctx.objects.emplace(std::make_pair(op.ctr, op.actor),
                                   std::move(obj));
    if (!ins.second) return false;        // duplicate objectId
  }
  BObj *parent = build_resolve_obj(ctx, op.obj_ctr, op.obj_actor);
  if (!parent) return false;

  if (op.insert) {
    if (!parent->is_seq || op.key_kind == 0) return false;
    std::list<BElem>::iterator pos;
    if (op.key_kind == 1) {
      pos = parent->elems.begin();
    } else {
      auto it = parent->elem_index.find(elem_key(op.ek_ctr, op.ek_actor));
      if (it == parent->elem_index.end()) return false;
      pos = std::next(it->second);
    }
    // concurrent-insert skip: pass elems whose id is greater than ours
    while (pos != parent->elems.end() &&
           lamport_lt(op.ctr, op.actor, pos->ctr, pos->actor))
      ++pos;
    BElem elem;
    elem.ctr = op.ctr;
    elem.actor = op.actor;
    if (!op.pred.empty()) return false;    // inserts carry no preds
    elem.rows.push_back(build_row_from(op));
    auto at = parent->elems.insert(pos, std::move(elem));
    if (!parent->elem_index.emplace(elem_key(op.ctr, op.actor), at).second)
      return false;                        // duplicate elemId
    return true;
  }

  // update (set / del / inc / make-at-key)
  std::vector<BRow> *rows;
  if (parent->is_seq) {
    if (op.key_kind != 2) return false;
    auto it = parent->elem_index.find(elem_key(op.ek_ctr, op.ek_actor));
    if (it == parent->elem_index.end()) return false;  // missing referent
    rows = &it->second->rows;
  } else {
    if (op.key_kind != 0) return false;
    std::u16string k16;
    if (!utf8_to_u16(op.key, k16)) return false;
    auto it = parent->keys.find(k16);
    if (it == parent->keys.end()) {
      it = parent->keys.emplace(k16, std::vector<BRow>()).first;
      parent->key_utf8.emplace(k16, op.key);
    }
    rows = &it->second;
  }
  // mark succ on preds (kept lamport-sorted), detect duplicates
  size_t seen = 0;
  for (auto &row : *rows) {
    if (row.ctr == op.ctr && row.actor == op.actor) return false;  // dup id
    for (auto &p : op.pred) {
      if (row.ctr == p.first && row.actor == p.second) {
        auto s = std::make_pair(op.ctr, int64_t(op.actor));
        auto at = std::lower_bound(
            row.succ.begin(), row.succ.end(),
            std::make_pair(op.ctr, op.actor),
            [](const std::pair<int64_t, int32_t> &x,
               const std::pair<int64_t, int32_t> &y) {
              return lamport_lt(x.first, x.second, y.first, y.second);
            });
        row.succ.insert(at, {op.ctr, op.actor});
        (void)s;
        seen++;
      }
    }
  }
  if (seen != op.pred.size()) return false;   // pred with no matching op
  if (op.action != 3) {                       // dels are succ-only
    auto at = std::lower_bound(
        rows->begin(), rows->end(), op,
        [](const BRow &r, const BOp &o) {
          return lamport_lt(r.ctr, r.actor, o.ctr, o.actor);
        });
    rows->insert(at, build_row_from(op));
  }
  return true;
}

// Canonical change order: Kahn topological traversal, ties broken on hash,
// with implicit per-actor seq edges (mirrors op_set._canonical_change_order).
static bool build_canonical_order(BuildCtx &ctx, std::vector<size_t> &order) {
  size_t n = ctx.changes.size();
  std::unordered_map<std::string, size_t> by_hash;
  for (size_t i = 0; i < n; i++) by_hash[ctx.changes[i].hash] = i;
  std::vector<std::vector<size_t>> children(n);
  std::vector<size_t> indeg(n, 0);
  for (size_t i = 0; i < n; i++) {
    for (auto &dep : ctx.changes[i].deps) {
      auto it = by_hash.find(dep);
      if (it == by_hash.end()) return false;
      children[it->second].push_back(i);
      indeg[i]++;
    }
  }
  std::unordered_map<std::string, std::vector<size_t>> by_actor;
  for (size_t i = 0; i < n; i++)
    by_actor[ctx.changes[i].actor_hex].push_back(i);
  for (auto &kv : by_actor) {
    auto idxs = kv.second;
    std::sort(idxs.begin(), idxs.end(), [&](size_t a, size_t b) {
      return ctx.changes[a].seq < ctx.changes[b].seq;
    });
    for (size_t k = 0; k + 1 < idxs.size(); k++) {
      children[idxs[k]].push_back(idxs[k + 1]);
      indeg[idxs[k + 1]]++;
    }
  }
  using HI = std::pair<std::string, size_t>;
  std::priority_queue<HI, std::vector<HI>, std::greater<HI>> heap;
  for (size_t i = 0; i < n; i++)
    if (indeg[i] == 0) heap.push({ctx.changes[i].hash, i});
  order.clear();
  while (!heap.empty()) {
    size_t i = heap.top().second;
    heap.pop();
    order.push_back(i);
    for (size_t c : children[i])
      if (--indeg[c] == 0) heap.push({ctx.changes[c].hash, c});
  }
  return order.size() == n;
}

static void emit_doc_row(const BRow &r, int64_t obj_ctr, int32_t obj_actor,
                         const std::string *map_key, BuildCtx &ctx,
                         RleEnc &obj_a, RleEnc &obj_c, RleEnc &key_a,
                         DeltaEnc &key_c, RleEnc &key_s, BoolEnc &ins,
                         RleEnc &act, RleEnc &vlen, ByteBuf &vraw,
                         RleEnc &chld_a, DeltaEnc &chld_c, RleEnc &id_a,
                         DeltaEnc &id_c, RleEnc &succ_n, RleEnc &succ_a,
                         DeltaEnc &succ_c) {
  if (obj_actor < 0) {
    obj_a.null_();
    obj_c.null_();
  } else {
    obj_a.value(obj_actor);
    obj_c.value(obj_ctr);
  }
  if (map_key) {
    key_a.null_();
    key_c.null_();
    key_s.str(*map_key);
  } else if (r.insert && r.key_kind == 1) {
    key_a.null_();
    key_c.value(0);
    key_s.null_();
  } else {
    key_a.value(r.key_kind == 2 ? r.ek_actor : r.actor);
    key_c.value(r.key_kind == 2 ? r.ek_ctr : r.ctr);
    key_s.null_();
  }
  ins.value(bool(r.insert));
  act.value(r.action);
  uint32_t ln = r.vtag >> 4;
  vlen.value(int64_t(r.vtag));
  if (ln) vraw.raw(ctx.vals.data() + r.voff, ln);
  chld_a.null_();
  chld_c.null_();
  id_a.value(r.actor);
  id_c.value(r.ctr);
  succ_n.value(int64_t(r.succ.size()));
  for (auto &s : r.succ) {
    succ_a.value(s.second);
    succ_c.value(s.first);
  }
}

static void deflate_maybe(uint32_t cid, std::vector<uint8_t> &buf,
                          std::vector<std::pair<uint32_t,
                                                std::vector<uint8_t>>> &cols) {
  if (buf.empty()) return;
  if (buf.size() >= 256) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) == Z_OK) {
      std::vector<uint8_t> out(deflateBound(&zs, buf.size()));
      zs.next_in = buf.data();
      zs.avail_in = uInt(buf.size());
      zs.next_out = out.data();
      zs.avail_out = uInt(out.size());
      if (deflate(&zs, Z_FINISH) == Z_STREAM_END) {
        out.resize(out.size() - zs.avail_out);
        deflateEnd(&zs);
        cols.emplace_back(cid | 8u, std::move(out));
        return;
      }
      deflateEnd(&zs);
    }
  }
  cols.emplace_back(cid, std::move(buf));
}

static bool build_serialize(BuildCtx &ctx,
                            const std::vector<std::string> &heads) {
  std::vector<size_t> order;
  if (!build_canonical_order(ctx, order)) return false;
  std::unordered_map<std::string, size_t> canon;
  for (size_t pos = 0; pos < order.size(); pos++)
    canon[ctx.changes[order[pos]].hash] = pos;

  // ---- ops columns in document order ----
  RleEnc obj_a(RleEnc::UINT), obj_c(RleEnc::UINT), key_a(RleEnc::UINT),
      key_s(RleEnc::UTF8), act(RleEnc::UINT), vlen(RleEnc::UINT),
      chld_a(RleEnc::UINT), id_a(RleEnc::UINT), succ_n(RleEnc::UINT),
      succ_a(RleEnc::UINT);
  DeltaEnc key_c, chld_c, id_c, succ_c;
  BoolEnc ins;
  ByteBuf vraw;

  auto emit_obj = [&](BObj &obj, int64_t octr, int32_t oactor) {
    if (obj.is_seq) {
      for (auto &elem : obj.elems)
        for (auto &r : elem.rows)
          emit_doc_row(r, octr, oactor, nullptr, ctx, obj_a, obj_c, key_a,
                       key_c, key_s, ins, act, vlen, vraw, chld_a, chld_c,
                       id_a, id_c, succ_n, succ_a, succ_c);
    } else {
      for (auto &kv : obj.keys) {
        const std::string &key = obj.key_utf8[kv.first];
        for (auto &r : kv.second)
          emit_doc_row(r, octr, oactor, &key, ctx, obj_a, obj_c, key_a,
                       key_c, key_s, ins, act, vlen, vraw, chld_a, chld_c,
                       id_a, id_c, succ_n, succ_a, succ_c);
      }
    }
  };
  emit_obj(ctx.root, 0, -1);
  for (auto &kv : ctx.objects)
    emit_obj(kv.second, kv.first.first, kv.first.second);

  // ---- changes metadata columns in canonical order ----
  RleEnc m_actor(RleEnc::UINT), m_msg(RleEnc::UTF8), m_depsn(RleEnc::UINT),
      m_extral(RleEnc::UINT);
  DeltaEnc m_seq, m_maxop, m_time, m_depsi;
  ByteBuf m_extrar;
  for (size_t pos = 0; pos < order.size(); pos++) {
    BChange &ch = ctx.changes[order[pos]];
    auto it = ctx.actor_index.find(ch.actor_hex);
    if (it == ctx.actor_index.end()) return false;
    m_actor.value(it->second);
    m_seq.value(int64_t(ch.seq));
    m_maxop.value(int64_t(ch.start_op + ch.ops.size() - 1));
    m_time.value(ch.time);
    m_msg.str(ch.message);
    std::vector<std::string> deps = ch.deps;
    std::sort(deps.begin(), deps.end());
    m_depsn.value(int64_t(deps.size()));
    for (auto &dep : deps) {
      auto d = canon.find(dep);
      if (d == canon.end()) return false;
      m_depsi.value(int64_t(d->second));
    }
    if (!ch.extra.empty()) {
      m_extrar.raw((const uint8_t *)ch.extra.data(), ch.extra.size());
      m_extral.value(int64_t((ch.extra.size() << 4) | 7));  // BYTES
    } else {
      m_extral.value(7);                                    // BYTES, len 0
    }
  }

  // ---- assemble container ----
  for (RleEnc *e : {&obj_a, &obj_c, &key_a, &key_s, &act, &vlen, &chld_a,
                    &id_a, &succ_n, &succ_a, &m_actor, &m_msg, &m_depsn,
                    &m_extral})
    e->finish();
  for (DeltaEnc *e : {&key_c, &chld_c, &id_c, &succ_c, &m_seq, &m_maxop,
                      &m_time, &m_depsi})
    e->finish();
  ins.finish();

  using Col = std::pair<uint32_t, std::vector<uint8_t>>;
  std::vector<Col> ccols, ocols;
  deflate_maybe(0x01, m_actor.out.b, ccols);
  deflate_maybe(0x03, m_seq.rle.out.b, ccols);
  deflate_maybe(0x13, m_maxop.rle.out.b, ccols);
  deflate_maybe(0x23, m_time.rle.out.b, ccols);
  deflate_maybe(0x35, m_msg.out.b, ccols);
  deflate_maybe(0x40, m_depsn.out.b, ccols);
  deflate_maybe(0x43, m_depsi.rle.out.b, ccols);
  deflate_maybe(0x56, m_extral.out.b, ccols);
  deflate_maybe(0x57, m_extrar.b, ccols);
  deflate_maybe(kColObjActor, obj_a.out.b, ocols);
  deflate_maybe(kColObjCtr, obj_c.out.b, ocols);
  deflate_maybe(kColKeyActor, key_a.out.b, ocols);
  deflate_maybe(kColKeyCtr, key_c.rle.out.b, ocols);
  deflate_maybe(kColKeyStr, key_s.out.b, ocols);
  deflate_maybe(kColInsert, ins.out.b, ocols);
  deflate_maybe(kColAction, act.out.b, ocols);
  deflate_maybe(kColValLen, vlen.out.b, ocols);
  deflate_maybe(kColValRaw, vraw.b, ocols);
  deflate_maybe(kColChldActor, chld_a.out.b, ocols);
  deflate_maybe(kColChldCtr, chld_c.rle.out.b, ocols);
  deflate_maybe(kColIdActor, id_a.out.b, ocols);
  deflate_maybe(kColIdCtr, id_c.rle.out.b, ocols);
  deflate_maybe(kColSuccNum, succ_n.out.b, ocols);
  deflate_maybe(kColSuccActor, succ_a.out.b, ocols);
  deflate_maybe(kColSuccCtr, succ_c.rle.out.b, ocols);
  auto by_id = [](const Col &a, const Col &b) {
    return (a.first & ~8u) < (b.first & ~8u);
  };
  std::sort(ccols.begin(), ccols.end(), by_id);
  std::sort(ocols.begin(), ocols.end(), by_id);

  ByteBuf body;
  body.uleb(ctx.actors.size());
  for (auto &a : ctx.actors) {
    body.uleb(a.size() / 2);
    for (size_t i = 0; i + 1 < a.size(); i += 2) {
      auto nib = [](char ch) -> uint8_t {
        return ch <= '9' ? ch - '0' : ch - 'a' + 10;
      };
      body.u8(uint8_t(nib(a[i]) << 4 | nib(a[i + 1])));
    }
  }
  std::vector<std::string> sheads = heads;
  std::sort(sheads.begin(), sheads.end());
  body.uleb(sheads.size());
  for (auto &h : sheads) {
    for (size_t i = 0; i + 1 < h.size(); i += 2) {
      auto nib = [](char ch) -> uint8_t {
        return ch <= '9' ? ch - '0' : ch - 'a' + 10;
      };
      body.u8(uint8_t(nib(h[i]) << 4 | nib(h[i + 1])));
    }
  }
  auto col_info = [&](std::vector<Col> &cols) {
    body.uleb(cols.size());
    for (auto &c : cols) {
      body.uleb(c.first);
      body.uleb(c.second.size());
    }
  };
  col_info(ccols);
  col_info(ocols);
  for (auto &c : ccols) body.raw(c.second.data(), c.second.size());
  for (auto &c : ocols) body.raw(c.second.data(), c.second.size());
  for (auto &h : sheads) {
    auto d = canon.find(h);
    if (d == canon.end()) return false;
    body.uleb(d->second);
  }

  ByteBuf chunk;
  chunk.u8(0);
  chunk.uleb(body.b.size());
  chunk.raw(body.b.data(), body.b.size());
  uint8_t digest[32];
  {
    Sha256Stream s;
    sha256_stream_init(s);
    sha256_stream_update(s, chunk.b.data(), chunk.b.size());
    sha256_stream_final(s, digest);
  }
  ctx.result.clear();
  const uint8_t magic[4] = {0x85, 0x6f, 0x4a, 0x83};
  ctx.result.insert(ctx.result.end(), magic, magic + 4);
  ctx.result.insert(ctx.result.end(), digest, digest + 4);
  ctx.result.insert(ctx.result.end(), chunk.b.begin(), chunk.b.end());
  return true;
}

static BuildCtx *g_build = nullptr;

}  // namespace

extern "C" {

// Build a canonical document container from a doc's change log (application
// order) + current heads (32 bytes each). Returns the result byte size, or
// -1 when the log needs the Python path (link/child/unknown columns,
// malformed history). Fetch with am_build_fetch.
int64_t am_build_document(const uint8_t *blob, const uint64_t *offsets,
                          const uint64_t *lens, uint64_t n_changes,
                          const uint8_t *heads, uint64_t n_heads) {
  delete g_build;
  g_build = new BuildCtx();
  BuildCtx &ctx = *g_build;
  std::vector<uint8_t> scratch;
  // pass 1: authors -> hex-sorted doc actor table
  for (uint64_t i = 0; i < n_changes; i++) {
    if (!build_parse_change(ctx, blob + offsets[i], lens[i], true, scratch))
      return -1;
  }
  std::vector<std::string> authors;
  for (auto &ch : ctx.changes) authors.push_back(ch.actor_hex);
  std::sort(authors.begin(), authors.end());
  authors.erase(std::unique(authors.begin(), authors.end()), authors.end());
  // elem_key packs actor indexes into 8 bits: larger actor populations
  // must take the Python path rather than alias elemIds
  if (authors.size() > 256) return -1;
  ctx.actors = authors;
  for (size_t i = 0; i < ctx.actors.size(); i++)
    ctx.actor_index[ctx.actors[i]] = int32_t(i);
  ctx.changes.clear();
  // pass 2: full parse with doc-table actor numbers
  for (uint64_t i = 0; i < n_changes; i++) {
    if (!build_parse_change(ctx, blob + offsets[i], lens[i], false, scratch))
      return -1;
  }
  // replay into the op store
  std::string k16;
  for (auto &ch : ctx.changes)
    for (auto &op : ch.ops)
      if (!build_apply_op(ctx, op, k16)) return -1;
  std::vector<std::string> head_hex;
  for (uint64_t i = 0; i < n_heads; i++)
    head_hex.push_back(to_hex(heads + 32 * i, 32));
  if (!build_serialize(ctx, head_hex)) return -1;
  return int64_t(ctx.result.size());
}

int64_t am_build_fetch(uint8_t *out, uint64_t cap) {
  if (!g_build) return -1;
  if (g_build->result.size() > cap) return -1;
  copy_bytes(out, g_build->result.data(), g_build->result.size());
  int64_t n = int64_t(g_build->result.size());
  delete g_build;
  g_build = nullptr;
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native change-list extraction: document chunk -> canonical per-change
// chunks + SHA-256 hashes (the inverse of am_build_document; ref
// columnar.js:1040-1047 decodeDocument). This is the delta+main engine's
// materialize kernel: a parked document revives its change log without the
// Python decode_document + encode_change round trip (~700us/doc ->
// ~100-150us/doc), and recovery / bulk load feed change buffers straight
// from parked chunks.
//
// Parity contract: when extraction SUCCEEDS its output is byte-identical
// to Python's decode_document + encode_change — both normalize the same
// way (value tags for non-set/inc actions collapse to NULL, zero-counter
// children collapse to null, preds/deps sort canonically) and both verify
// that the re-encoded hash frontier reproduces the header's heads. Every
// change is an ancestor of some head, so ANY byte divergence cascades into
// the heads check; extraction bails (caller falls back to Python, which
// reproduces the exact typed verdict) on anything it cannot prove it
// normalizes identically: unknown columns, unknown value types with
// ambiguous round-trips, non-minimal LEB payloads, invalid UTF-8, link
// ops, del rows in the ops table, null change-meta fields Python raises
// on. Per-doc extraction is independent, so the pool fan-out is
// byte-identical at every width by construction.
// ---------------------------------------------------------------------------

namespace {

// Strict UTF-8 validation matching CPython's decoder (encoding.py
// read_prefixed_string): rejects overlong forms, surrogates, > U+10FFFF.
// Python re-encodes decoded strings verbatim only for valid input; invalid
// input raises typed — so the extractor bails to keep verdicts identical.
static bool validate_utf8(const uint8_t *p, uint64_t n) {
  uint64_t i = 0;
  while (i < n) {
    uint8_t b = p[i];
    uint32_t cp;
    uint64_t need;
    if (b < 0x80) { cp = b; need = 1; }
    else if ((b >> 5) == 6) { cp = b & 0x1f; need = 2; }
    else if ((b >> 4) == 14) { cp = b & 0x0f; need = 3; }
    else if ((b >> 3) == 30) { cp = b & 0x07; need = 4; }
    else return false;
    if (i + need > n) return false;
    for (uint64_t k = 1; k < need; k++) {
      if ((p[i + k] >> 6) != 2) return false;
      cp = (cp << 6) | (p[i + k] & 0x3f);
    }
    static const uint32_t min_cp[5] = {0, 0, 0x80, 0x800, 0x10000};
    if (cp < min_cp[need]) return false;
    if (cp >= 0xd800 && cp <= 0xdfff) return false;
    if (cp > 0x10ffff) return false;
    i += need;
  }
  return true;
}

// RLE utf8 column -> per-row interned string ids (-1 = null), strict utf8,
// count-bombs capped. (decode_keystr is the no-null-validation variant the
// doc parser uses; messages and extraction keys need the strict one.)
static bool decode_strcol_strict(const uint8_t *buf, uint64_t len,
                                 Interner &pool, std::vector<int32_t> &out) {
  Cursor c{buf, len};
  while (c.pos < c.len && !c.fail) {
    int64_t count = c.sleb();
    if (c.fail) return false;
    if (count > 1) {
      if (count > kMaxColumnValues - int64_t(out.size())) return false;
      uint64_t slen = c.uleb();
      const uint8_t *p = c.bytes(slen);
      if (c.fail || !validate_utf8(p, slen)) return false;
      int32_t id = pool.intern(std::string((const char *)p, slen));
      for (int64_t i = 0; i < count; i++) out.push_back(id);
    } else if (count == 1) {
      return false;              // non-canonical lone run
    } else if (count < 0) {
      if (-count > kMaxColumnValues - int64_t(out.size())) return false;
      for (int64_t i = 0; i < -count; i++) {
        uint64_t slen = c.uleb();
        const uint8_t *p = c.bytes(slen);
        if (c.fail || !validate_utf8(p, slen)) return false;
        out.push_back(pool.intern(std::string((const char *)p, slen)));
      }
    } else {
      uint64_t nulls = c.uleb();
      if (c.fail || nulls > uint64_t(kMaxColumnValues - int64_t(out.size())))
        return false;
      for (uint64_t i = 0; i < nulls; i++) out.push_back(-1);
    }
  }
  return !c.fail;
}

struct XOp {
  int64_t ctr = 0;
  int32_t actor = -1;             // local doc-actor index
  int64_t obj_ctr = 0;
  int32_t obj_actor = -1;         // -1 = root
  int8_t key_kind = 0;            // 0 = map key, 1 = _head, 2 = elemId
  int32_t key_str = -1;           // interned map key
  int64_t ek_ctr = 0;
  int32_t ek_actor = -1;
  uint8_t insert = 0;
  uint8_t action = 0;
  uint32_t vtag = 0;              // normalized valLen tag (len<<4 | type)
  uint64_t voff = 0;              // into the per-doc value arena
  int64_t chld_ctr = 0;
  int32_t chld_actor = -1;        // -1 = none
  std::vector<std::pair<int64_t, int32_t>> pred;   // (ctr, local actor)
};

struct XChange {
  int32_t actor = -1;             // local doc-actor index
  int64_t seq = 0, max_op = 0, time = 0;
  int32_t msg = -1;               // interned message id (-1 = null)
  std::vector<int64_t> deps_idx;  // indexes into the doc's change list
  const uint8_t *extra = nullptr;
  uint64_t extra_len = 0;
  std::vector<int32_t> ops;       // indexes into the op pool, sorted by ctr
  uint8_t hash[32];
};

struct DocExtract {
  uint8_t ok = 0;
  std::vector<uint8_t> blob;      // concatenated canonical change chunks
  std::vector<int64_t> lens;      // per-change chunk byte length
  std::vector<uint8_t> hashes;    // 32 bytes per change
  std::vector<int64_t> max_ops;   // per-change maxOp
};

// Encode one reconstructed change as its canonical chunk (encode_change,
// ref columnar.js:710-739), appending to doc.blob. Returns false on shapes
// Python's encoder would reject.
constexpr int64_t kMaxSafeInt = (int64_t(1) << 53) - 1;

static bool encode_extracted_change(
    XChange &ch, const std::vector<XOp> &pool,
    const std::vector<std::string> &actors, const Interner &keys,
    const Interner &msgs, const std::vector<uint8_t> &vals,
    const std::vector<XChange> &changes, DocExtract &doc) {
  // per-change actor table: change actor first, others hex-sorted
  std::vector<int32_t> tbl_of(actors.size(), -1);
  std::vector<int32_t> referenced;
  auto touch = [&](int32_t a) {
    if (a >= 0 && tbl_of[size_t(a)] < 0) {
      tbl_of[size_t(a)] = 0;        // mark; numbered below
      referenced.push_back(a);
    }
  };
  touch(ch.actor);
  for (int32_t oi : ch.ops) {
    const XOp &op = pool[size_t(oi)];
    touch(op.obj_actor);
    if (op.key_kind == 2) touch(op.ek_actor);
    if (op.chld_actor >= 0 && op.chld_ctr != 0) touch(op.chld_actor);
    for (auto &p : op.pred) touch(p.second);
  }
  std::vector<int32_t> others;
  for (int32_t a : referenced)
    if (a != ch.actor) others.push_back(a);
  std::sort(others.begin(), others.end(), [&](int32_t x, int32_t y) {
    return actors[size_t(x)] < actors[size_t(y)];
  });
  tbl_of[size_t(ch.actor)] = 0;
  for (size_t i = 0; i < others.size(); i++)
    tbl_of[size_t(others[i])] = int32_t(i + 1);

  // ---- op columns (CHANGE_COLUMNS; ids ascending) ----
  RleEnc obj_a(RleEnc::UINT), obj_c(RleEnc::UINT), key_a(RleEnc::UINT),
      key_s(RleEnc::UTF8), act(RleEnc::UINT), vlen(RleEnc::UINT),
      chld_a(RleEnc::UINT), pred_n(RleEnc::UINT), pred_a(RleEnc::UINT);
  DeltaEnc key_c, chld_c, pred_c;
  BoolEnc ins;
  ByteBuf vraw;
  for (int32_t oi : ch.ops) {
    const XOp &op = pool[size_t(oi)];
    if (op.obj_actor < 0) {
      obj_a.null_();
      obj_c.null_();
    } else {
      obj_a.value(tbl_of[size_t(op.obj_actor)]);
      obj_c.value(op.obj_ctr);
    }
    if (op.key_kind == 0) {
      // empty map keys fail Python's falsy key check — stay identical
      if (op.key_str < 0 || keys.items[size_t(op.key_str)].empty())
        return false;
      key_a.null_();
      key_c.null_();
      key_s.str(keys.items[size_t(op.key_str)]);
    } else if (op.key_kind == 1) {
      if (!op.insert) return false;   // _head on a non-insert: Python raises
      key_a.null_();
      key_c.value(0);
      key_s.null_();
    } else {
      if (op.ek_actor < 0 || op.ek_ctr <= 0) return false;
      key_a.value(tbl_of[size_t(op.ek_actor)]);
      key_c.value(op.ek_ctr);
      key_s.null_();
    }
    ins.value(bool(op.insert));
    act.value(op.action);
    // value: set/inc keep their (normalized) tag + raw bytes; all other
    // actions encode NULL (encode_value_to_columns' action gate)
    if ((op.action == 1 || op.action == 5) && op.vtag != 0) {
      uint32_t ln = op.vtag >> 4;
      uint8_t vt = uint8_t(op.vtag & 0xf);
      if (vt == 1 || vt == 2) {
        vlen.value(int64_t(vt));      // FALSE/TRUE carry no payload
      } else {
        vlen.value(int64_t(op.vtag));
        if (ln) vraw.raw(vals.data() + op.voff, ln);
      }
    } else {
      vlen.value(0);                  // NULL
    }
    if (op.chld_actor >= 0 && op.chld_ctr != 0) {
      chld_a.value(tbl_of[size_t(op.chld_actor)]);
      chld_c.value(op.chld_ctr);
    } else {
      chld_a.null_();
      chld_c.null_();
    }
    // preds sorted by (ctr, actor hex) — ParsedOpId.sort_key
    std::vector<std::pair<int64_t, int32_t>> pred = op.pred;
    std::sort(pred.begin(), pred.end(),
              [&](const std::pair<int64_t, int32_t> &x,
                  const std::pair<int64_t, int32_t> &y) {
                if (x.first != y.first) return x.first < y.first;
                return actors[size_t(x.second)] < actors[size_t(y.second)];
              });
    for (size_t i = 1; i < pred.size(); i++)
      if (pred[i - 1].first == pred[i].first &&
          pred[i - 1].second == pred[i].second)
        return false;                 // duplicate pred: decode would raise
    pred_n.value(int64_t(pred.size()));
    for (auto &p : pred) {
      pred_a.value(tbl_of[size_t(p.second)]);
      pred_c.value(p.first);
    }
  }
  for (RleEnc *e : {&obj_a, &obj_c, &key_a, &key_s, &act, &vlen, &chld_a,
                    &pred_n, &pred_a})
    e->finish();
  for (DeltaEnc *e : {&key_c, &chld_c, &pred_c}) e->finish();
  ins.finish();

  // ---- body (encode_change layout) ----
  ByteBuf body;
  {
    // deps: resolved hashes, sorted bytewise (== hex sort)
    std::vector<const uint8_t *> deps;
    for (int64_t di : ch.deps_idx) deps.push_back(changes[size_t(di)].hash);
    std::sort(deps.begin(), deps.end(),
              [](const uint8_t *a, const uint8_t *b) {
                return memcmp(a, b, 32) < 0;
              });
    body.uleb(deps.size());
    for (const uint8_t *d : deps) body.raw(d, 32);
  }
  const std::string &ahex = actors[size_t(ch.actor)];
  auto hex_bytes = [&](const std::string &h) {
    body.uleb(h.size() / 2);
    for (size_t i = 0; i + 1 < h.size(); i += 2) {
      auto nib = [](char c) -> uint8_t {
        return c <= '9' ? uint8_t(c - '0') : uint8_t(c - 'a' + 10);
      };
      body.u8(uint8_t(nib(h[i]) << 4 | nib(h[i + 1])));
    }
  };
  hex_bytes(ahex);
  // Python's append_uint53/append_int53 bound every header field
  if (ch.seq <= 0 || ch.seq > kMaxSafeInt) return false;
  body.uleb(uint64_t(ch.seq));
  int64_t start_op = ch.max_op - int64_t(ch.ops.size()) + 1;
  if (start_op < 0 || start_op > kMaxSafeInt) return false;
  body.uleb(uint64_t(start_op));
  if (ch.time < -kMaxSafeInt || ch.time > kMaxSafeInt) return false;
  body.sleb(ch.time);
  if (ch.msg < 0) {
    body.uleb(0);
  } else {
    const std::string &m = msgs.items[size_t(ch.msg)];
    body.uleb(m.size());
    body.raw((const uint8_t *)m.data(), m.size());
  }
  body.uleb(others.size());
  for (int32_t a : others) hex_bytes(actors[size_t(a)]);
  using Col = std::pair<uint32_t, std::vector<uint8_t> *>;
  std::vector<Col> cols = {
      {kColObjActor, &obj_a.out.b}, {kColObjCtr, &obj_c.out.b},
      {kColKeyActor, &key_a.out.b}, {kColKeyCtr, &key_c.rle.out.b},
      {kColKeyStr, &key_s.out.b},   {kColInsert, &ins.out.b},
      {kColAction, &act.out.b},     {kColValLen, &vlen.out.b},
      {kColValRaw, &vraw.b},        {kColChldActor, &chld_a.out.b},
      {kColChldCtr, &chld_c.rle.out.b}, {kColPredNum, &pred_n.out.b},
      {kColPredActor, &pred_a.out.b},   {kColPredCtr, &pred_c.rle.out.b}};
  std::sort(cols.begin(), cols.end(),
            [](const Col &a, const Col &b) { return a.first < b.first; });
  uint64_t n_cols = 0;
  for (auto &c : cols)
    if (!c.second->empty()) n_cols++;
  body.uleb(n_cols);
  for (auto &c : cols) {
    if (c.second->empty()) continue;
    body.uleb(c.first);
    body.uleb(c.second->size());
  }
  for (auto &c : cols)
    if (!c.second->empty()) body.raw(c.second->data(), c.second->size());
  if (ch.extra_len) body.raw(ch.extra, ch.extra_len);

  // ---- container + hash (+ canonical DEFLATE past 256 bytes) ----
  ByteBuf framed;
  framed.u8(1);
  framed.uleb(body.b.size());
  framed.raw(body.b.data(), body.b.size());
  uint8_t digest[32];
  {
    Sha256Stream s;
    sha256_stream_init(s);
    sha256_stream_update(s, framed.b.data(), framed.b.size());
    sha256_stream_final(s, digest);
  }
  const uint8_t magic[4] = {0x85, 0x6f, 0x4a, 0x83};
  size_t chunk_start = doc.blob.size();
  if (8 + framed.b.size() >= 256) {
    // deflate_change: magic + checksum of the UNCOMPRESSED form, type 2,
    // LEB compressed length, raw-DEFLATE body (level 6, matching Python)
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
      return false;
    std::vector<uint8_t> comp(deflateBound(&zs, uInt(body.b.size())));
    zs.next_in = body.b.data();
    zs.avail_in = uInt(body.b.size());
    zs.next_out = comp.data();
    zs.avail_out = uInt(comp.size());
    if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
      deflateEnd(&zs);
      return false;
    }
    comp.resize(comp.size() - zs.avail_out);
    deflateEnd(&zs);
    doc.blob.insert(doc.blob.end(), magic, magic + 4);
    doc.blob.insert(doc.blob.end(), digest, digest + 4);
    ByteBuf dh;
    dh.u8(2);
    dh.uleb(comp.size());
    doc.blob.insert(doc.blob.end(), dh.b.begin(), dh.b.end());
    doc.blob.insert(doc.blob.end(), comp.begin(), comp.end());
  } else {
    doc.blob.insert(doc.blob.end(), magic, magic + 4);
    doc.blob.insert(doc.blob.end(), digest, digest + 4);
    doc.blob.insert(doc.blob.end(), framed.b.begin(), framed.b.end());
  }
  doc.lens.push_back(int64_t(doc.blob.size() - chunk_start));
  doc.hashes.insert(doc.hashes.end(), digest, digest + 32);
  doc.max_ops.push_back(ch.max_op);
  copy_bytes(ch.hash, digest, 32);
  return true;
}

// Extract one document chunk into per-change canonical chunks; returns
// false (doc.ok stays 0, partial output discarded by the caller using a
// fresh DocExtract) when the doc needs the Python path.
static bool extract_document_body(const uint8_t *chunk, uint64_t chunk_len,
                                  DocExtract &doc) {
  Cursor c{chunk, chunk_len};
  const uint8_t *magic = c.bytes(4);
  if (c.fail || memcmp(magic, "\x85\x6f\x4a\x83", 4) != 0) return false;
  const uint8_t *checksum = c.bytes(4);
  uint64_t hash_start = c.pos;
  if (c.fail || c.pos >= chunk_len) return false;
  uint8_t chunk_type = chunk[c.pos];
  c.skip(1);
  uint64_t body_len = c.uleb();
  if (c.fail || chunk_type != 0) return false;
  const uint8_t *body = c.bytes(body_len);
  if (c.fail || c.pos != chunk_len) return false;
  {
    uint8_t digest[32];
    Sha256Stream s;
    sha256_stream_init(s);
    sha256_stream_update(s, chunk + hash_start, c.pos - hash_start);
    sha256_stream_final(s, digest);
    if (memcmp(digest, checksum, 4) != 0) return false;
  }

  Cursor b{body, body_len};
  uint64_t n_actors = b.uleb();
  if (b.fail || n_actors > (1u << 20)) return false;
  std::vector<std::string> actors;
  for (uint64_t i = 0; i < n_actors; i++) {
    uint64_t alen = b.uleb();
    const uint8_t *raw = b.bytes(alen);
    if (b.fail) return false;
    actors.push_back(to_hex(raw, alen));
  }
  uint64_t n_heads = b.uleb();
  if (b.fail || n_heads > (1u << 20)) return false;
  std::vector<const uint8_t *> heads;
  for (uint64_t i = 0; i < n_heads; i++) {
    const uint8_t *h = b.bytes(32);
    if (b.fail) return false;
    heads.push_back(h);
  }
  auto read_col_info = [&](std::vector<DocColumn> &cols) -> bool {
    uint64_t n = b.uleb();
    if (b.fail || n > 4096) return false;
    uint32_t last_id = 0;
    bool first = true;
    for (uint64_t i = 0; i < n; i++) {
      DocColumn col;
      col.id = uint32_t(b.uleb());
      col.len = b.uleb();
      if (b.fail) return false;
      uint32_t bare = col.id & ~uint32_t(kDeflateBit);
      if (!first && bare <= (last_id & ~uint32_t(kDeflateBit))) return false;
      last_id = col.id;
      first = false;
      cols.push_back(col);
    }
    return true;
  };
  std::vector<DocColumn> ccols, ocols;
  if (!read_col_info(ccols) || !read_col_info(ocols)) return false;
  for (auto *cols : {&ccols, &ocols}) {
    for (auto &col : *cols) {
      col.buf = b.bytes(col.len);
      if (b.fail) return false;
      if (col.id & kDeflateBit) {
        if (!inflate_vec(col.buf, col.len, col.inflated)) return false;
        col.id &= ~uint32_t(kDeflateBit);
        col.buf = col.inflated.data();
        col.len = col.inflated.size();
      }
    }
  }
  // optional headsIndexes + doc-level extraBytes (both ignored by the
  // Python decode path too)
  if (b.pos < b.len) {
    for (uint64_t i = 0; i < n_heads; i++) b.uleb();
    if (b.fail) return false;
  }

  auto find = [](std::vector<DocColumn> &cols, uint32_t id) -> DocColumn * {
    for (auto &col : cols) if (col.id == id) return &col;
    return nullptr;
  };

  // ---- change metadata columns ----
  for (auto &col : ccols) {
    switch (col.id) {
      case kDocActor: case kDocSeq: case kDocMaxOp: case kDocTime:
      case kDocMessage: case kDocDepsNum: case kDocDepsIndex:
      case kDocExtraLen: case kDocExtraRaw:
        break;
      default:
        return false;           // unknown change-meta column: Python path
    }
  }
  auto dec = [&](std::vector<DocColumn> &cols, uint32_t id, bool sgn,
                 bool delta, std::vector<int64_t> &v,
                 std::vector<uint8_t> &m) {
    DocColumn *col = find(cols, id);
    if (!col) { v.clear(); m.clear(); return true; }
    return decode_i64_col(col->buf, col->len, sgn, delta, v, m);
  };
  std::vector<int64_t> cm_actor, cm_seq, cm_maxop, cm_time, cm_depsn,
      cm_depsi, cm_extral;
  std::vector<uint8_t> cm_actor_m, cm_seq_m, cm_maxop_m, cm_time_m,
      cm_depsn_m, cm_depsi_m, cm_extral_m;
  if (!dec(ccols, kDocActor, false, false, cm_actor, cm_actor_m) ||
      !dec(ccols, kDocSeq, false, true, cm_seq, cm_seq_m) ||
      !dec(ccols, kDocMaxOp, false, true, cm_maxop, cm_maxop_m) ||
      !dec(ccols, kDocTime, false, true, cm_time, cm_time_m) ||
      !dec(ccols, kDocDepsNum, false, false, cm_depsn, cm_depsn_m) ||
      !dec(ccols, kDocDepsIndex, false, true, cm_depsi, cm_depsi_m) ||
      !dec(ccols, kDocExtraLen, false, false, cm_extral, cm_extral_m))
    return false;
  size_t n_changes = cm_actor.size();
  if (cm_seq.size() != n_changes || cm_maxop.size() != n_changes)
    return false;
  Interner msgs;
  std::vector<int32_t> cm_msg;
  {
    DocColumn *col = find(ccols, kDocMessage);
    if (col) {
      if (!decode_strcol_strict(col->buf, col->len, msgs, cm_msg))
        return false;
      if (cm_msg.size() != n_changes) return false;
    } else {
      cm_msg.assign(n_changes, -1);
    }
  }
  auto padn = [&](std::vector<int64_t> &v, std::vector<uint8_t> &m,
                  size_t n) {
    if (v.empty()) { v.assign(n, 0); m.assign(n, 0); }
    return v.size() == n;
  };
  if (!padn(cm_time, cm_time_m, n_changes) ||
      !padn(cm_depsn, cm_depsn_m, n_changes) ||
      !padn(cm_extral, cm_extral_m, n_changes))
    return false;
  uint64_t deps_total = 0;
  for (size_t i = 0; i < n_changes; i++)
    deps_total += cm_depsn_m[i] ? uint64_t(cm_depsn[i]) : 0;
  if (cm_depsi.size() != deps_total) return false;
  DocColumn *xraw = find(ccols, kDocExtraRaw);
  const uint8_t *extra_buf = xraw ? xraw->buf : nullptr;
  uint64_t extra_len_total = xraw ? xraw->len : 0;

  std::vector<XChange> changes(n_changes);
  {
    uint64_t dpos = 0, xpos = 0;
    for (size_t i = 0; i < n_changes; i++) {
      XChange &ch = changes[i];
      // null actor/seq/maxOp/time -> Python raises in re-encode: bail
      if (!cm_actor_m[i] || !cm_seq_m[i] || !cm_maxop_m[i] || !cm_time_m[i])
        return false;
      if (cm_actor[i] < 0 || uint64_t(cm_actor[i]) >= actors.size())
        return false;
      ch.actor = int32_t(cm_actor[i]);
      ch.seq = cm_seq[i];
      ch.max_op = cm_maxop[i];
      ch.time = cm_time[i];
      ch.msg = cm_msg[i];
      uint64_t nd = cm_depsn_m[i] ? uint64_t(cm_depsn[i]) : 0;
      for (uint64_t k = 0; k < nd; k++, dpos++) {
        if (!cm_depsi_m[dpos]) return false;
        int64_t di = cm_depsi[dpos];
        if (di < 0 || uint64_t(di) >= i) return false;  // forward dep: bail
        ch.deps_idx.push_back(di);
      }
      // extraLen must be a BYTES tag (decode_document_changes' check)
      if (!cm_extral_m[i]) return false;
      uint64_t tag = uint64_t(cm_extral[i]);
      if ((tag & 0xf) != 7) return false;
      uint64_t xlen = tag >> 4;
      if (xpos + xlen > extra_len_total) return false;
      ch.extra = extra_buf + xpos;
      ch.extra_len = xlen;
      xpos += xlen;
    }
    if (dpos != deps_total || xpos != extra_len_total) return false;
  }

  // ---- ops columns ----
  for (auto &col : ocols) {
    switch (col.id) {
      case kColObjActor: case kColObjCtr: case kColKeyActor: case kColKeyCtr:
      case kColKeyStr: case kColIdActor: case kColIdCtr: case kColInsert:
      case kColAction: case kColValLen: case kColValRaw:
      case kColChldActor: case kColChldCtr:
      case kColSuccNum: case kColSuccActor: case kColSuccCtr:
        break;
      default:
        return false;           // unknown ops column: Python path
    }
  }
  std::vector<int64_t> obj_a, obj_c, key_a, key_c, id_a, id_c, act_v, vlen_v,
      chld_a, chld_c, succ_n, succ_a, succ_c;
  std::vector<uint8_t> obj_am, obj_cm, key_am, key_cm, id_am, id_cm, act_m,
      vlen_m, chld_am, chld_cm, succ_nm, succ_am, succ_cm;
  if (!dec(ocols, kColObjActor, false, false, obj_a, obj_am) ||
      !dec(ocols, kColObjCtr, false, false, obj_c, obj_cm) ||
      !dec(ocols, kColKeyActor, false, false, key_a, key_am) ||
      !dec(ocols, kColKeyCtr, false, true, key_c, key_cm) ||
      !dec(ocols, kColIdActor, false, false, id_a, id_am) ||
      !dec(ocols, kColIdCtr, false, true, id_c, id_cm) ||
      !dec(ocols, kColAction, false, false, act_v, act_m) ||
      !dec(ocols, kColValLen, false, false, vlen_v, vlen_m) ||
      !dec(ocols, kColChldActor, false, false, chld_a, chld_am) ||
      !dec(ocols, kColChldCtr, false, true, chld_c, chld_cm) ||
      !dec(ocols, kColSuccNum, false, false, succ_n, succ_nm) ||
      !dec(ocols, kColSuccActor, false, false, succ_a, succ_am) ||
      !dec(ocols, kColSuccCtr, false, true, succ_c, succ_cm))
    return false;
  size_t n_ops = id_c.size();
  if (id_a.size() != n_ops || act_v.size() != n_ops) return false;
  std::vector<int64_t> ins_v(n_ops);
  std::vector<uint8_t> ins_m(n_ops);
  {
    DocColumn *col = find(ocols, kColInsert);
    if (col) {
      if (am_decode_boolean(col->buf, col->len, ins_v.data(), ins_m.data(),
                            int64_t(n_ops)) != int64_t(n_ops))
        return false;
    } else if (n_ops) {
      return false;
    }
  }
  Interner keys;
  std::vector<int32_t> key_str;
  {
    DocColumn *col = find(ocols, kColKeyStr);
    if (col) {
      if (!decode_strcol_strict(col->buf, col->len, keys, key_str))
        return false;
      if (key_str.size() != n_ops) return false;
    } else {
      key_str.assign(n_ops, -1);
    }
  }
  if (!padn(obj_a, obj_am, n_ops) || !padn(obj_c, obj_cm, n_ops) ||
      !padn(key_a, key_am, n_ops) || !padn(key_c, key_cm, n_ops) ||
      !padn(vlen_v, vlen_m, n_ops) || !padn(chld_a, chld_am, n_ops) ||
      !padn(chld_c, chld_cm, n_ops) || !padn(succ_n, succ_nm, n_ops))
    return false;
  uint64_t succ_total = 0;
  for (size_t i = 0; i < n_ops; i++)
    succ_total += succ_nm[i] ? uint64_t(succ_n[i]) : 0;
  if (succ_a.size() != succ_total || succ_c.size() != succ_total)
    return false;
  DocColumn *vraw_col = find(ocols, kColValRaw);
  const uint8_t *raw_buf = vraw_col ? vraw_col->buf : nullptr;
  uint64_t raw_len = vraw_col ? vraw_col->len : 0;

  // ---- reconstruct ops; redistribute into changes (group_change_ops) ----
  // changes_by_actor: Python enforces seq == count+1 in column order and
  // maxOp monotonic per actor
  std::unordered_map<int32_t, std::vector<int32_t>> by_actor;
  for (size_t i = 0; i < n_changes; i++) {
    auto &list = by_actor[changes[i].actor];
    if (changes[i].seq != int64_t(list.size()) + 1) return false;
    if (!list.empty() &&
        changes[size_t(list.back())].max_op > changes[i].max_op)
      return false;
    list.push_back(int32_t(i));
  }

  std::vector<uint8_t> vals;          // raw value bytes arena
  std::vector<XOp> pool;
  pool.reserve(n_ops);
  // (ctr << 20 | actor) -> pool index; actors bounded above by 2^20
  std::unordered_map<int64_t, int32_t> by_id;
  auto idkey = [](int64_t ctr, int32_t actor) -> int64_t {
    return (ctr << 20) | int64_t(uint32_t(actor));
  };
  if (actors.size() > (1u << 20)) return false;
  uint64_t raw_pos = 0, succ_pos = 0;
  for (size_t i = 0; i < n_ops; i++) {
    if (!id_am[i] || !id_cm[i] || !act_m[i]) return false;
    int64_t action = act_v[i];
    // del rows never appear in documents; link (7) and unknown numeric
    // actions take the Python path
    if (action < 0 || action > 6 || action == 3) return false;
    if (uint64_t(id_a[i]) >= actors.size()) return false;
    if (id_c[i] <= 0 || id_c[i] >= (int64_t(1) << 40)) return false;
    XOp op;
    op.ctr = id_c[i];
    op.actor = int32_t(id_a[i]);
    op.action = uint8_t(action);
    op.insert = uint8_t(ins_m[i] ? ins_v[i] : 0);
    if (obj_am[i] != obj_cm[i]) return false;
    if (obj_am[i]) {
      if (uint64_t(obj_a[i]) >= actors.size()) return false;
      op.obj_actor = int32_t(obj_a[i]);
      op.obj_ctr = obj_c[i];
    }
    if (key_str[i] >= 0) {
      if (key_am[i] || key_cm[i]) return false;
      op.key_kind = 0;
      op.key_str = key_str[i];
    } else if (key_cm[i] && key_c[i] == 0 && !key_am[i]) {
      op.key_kind = 1;
    } else if (key_cm[i] && key_am[i]) {
      if (uint64_t(key_a[i]) >= actors.size()) return false;
      op.key_kind = 2;
      op.ek_ctr = key_c[i];
      op.ek_actor = int32_t(key_a[i]);
    } else {
      return false;
    }
    if (chld_am[i] != chld_cm[i]) return false;
    if (chld_am[i]) {
      if (uint64_t(chld_a[i]) >= actors.size()) return false;
      op.chld_actor = int32_t(chld_a[i]);
      op.chld_ctr = chld_c[i];
    }
    // value: normalize exactly as Python's decode+re-encode round trip
    if (vlen_m[i]) {
      uint64_t tag = uint64_t(vlen_v[i]);
      uint8_t vt = uint8_t(tag & 0xf);
      uint32_t ln = uint32_t(tag >> 4);
      if (raw_pos + ln > raw_len) return false;
      const uint8_t *vp = raw_buf + raw_pos;
      if (ln == 0 && (vt == 0 || vt == 1 || vt == 2)) {
        op.vtag = vt;                 // NULL / FALSE / TRUE, no payload
      } else if (vt == 0 || vt == 1 || vt == 2) {
        // a NULL/FALSE/TRUE tag with payload bytes decodes to a raw-bytes
        // value in Python (decode_value's fallthrough) and re-encodes as
        // BYTES — normalize the same way
        op.vtag = (ln << 4) | 7u;
        op.voff = vals.size();
        vals.insert(vals.end(), vp, vp + ln);
      } else if (vt == 3 || vt == 4 || vt == 8 || vt == 9) {
        // minimal-LEB + int53-range check: Python's read/append round
        // trip must reproduce the bytes or raise
        uint64_t p = 0;
        int err = 0;
        int64_t v;
        if (vt == 3) {
          uint64_t uv = read_uleb(vp, ln, &p, &err);
          if (uv > uint64_t(kMaxSafeInt)) return false;
          v = int64_t(uv);
        } else {
          v = read_sleb(vp, ln, &p, &err);
          if (v < -kMaxSafeInt || v > kMaxSafeInt) return false;
        }
        if (err || p != ln) return false;
        // reject non-minimal encodings (Python would shrink them)
        if (ln > 1) {
          uint8_t last = vp[ln - 1];
          if (vt == 3 && last == 0) return false;
          if (vt != 3) {
            uint8_t prev_top = vp[ln - 2] & 0x40;
            if ((last == 0x00 && !prev_top) || (last == 0x7f && prev_top))
              return false;
          }
        }
        (void)v;
        op.vtag = uint32_t(tag);
        op.voff = vals.size();
        vals.insert(vals.end(), vp, vp + ln);
      } else if (vt == 5) {
        if (ln != 8) return false;    // Python: invalid float length
        op.vtag = uint32_t(tag);
        op.voff = vals.size();
        vals.insert(vals.end(), vp, vp + ln);
      } else if (vt == 6) {
        if (!validate_utf8(vp, ln)) return false;
        op.vtag = uint32_t(tag);
        op.voff = vals.size();
        vals.insert(vals.end(), vp, vp + ln);
      } else {
        // BYTES (7) and unknown tags 10-15 round-trip verbatim
        op.vtag = uint32_t(tag);
        op.voff = vals.size();
        vals.insert(vals.end(), vp, vp + ln);
      }
      raw_pos += ln;
    }
    int32_t pool_idx;
    auto it = by_id.find(idkey(op.ctr, op.actor));
    if (it != by_id.end()) {
      XOp &ph = pool[size_t(it->second)];
      // only a synthesized del placeholder (action 3; real del rows bail
      // above) may be superseded — a second real op with the same id is
      // a duplicate the Python path would also reject downstream
      if (ph.action != 3) return false;
      // placeholder created by an earlier succ ref: adopt its preds
      op.pred = std::move(ph.pred);
      ph = op;
      pool_idx = it->second;
    } else {
      pool.push_back(std::move(op));
      pool_idx = int32_t(pool.size() - 1);
      by_id.emplace(idkey(pool[size_t(pool_idx)].ctr,
                          pool[size_t(pool_idx)].actor),
                    pool_idx);
    }
    // succ entries: strictly ascending by (ctr, actor hex)
    uint64_t ns = succ_nm[i] ? uint64_t(succ_n[i]) : 0;
    int64_t prev_ctr = -1;
    int32_t prev_actor = -1;
    for (uint64_t k = 0; k < ns; k++, succ_pos++) {
      if (!succ_am[succ_pos] || !succ_cm[succ_pos]) return false;
      if (uint64_t(succ_a[succ_pos]) >= actors.size()) return false;
      int64_t sc = succ_c[succ_pos];
      int32_t sa = int32_t(succ_a[succ_pos]);
      if (prev_ctr >= 0) {
        if (sc < prev_ctr ||
            (sc == prev_ctr &&
             actors[size_t(sa)] <= actors[size_t(prev_actor)]))
          return false;               // Python: ids not ascending
      }
      prev_ctr = sc;
      prev_actor = sa;
      if (sc <= 0 || sc >= (int64_t(1) << 40)) return false;
      auto sit = by_id.find(idkey(sc, sa));
      int32_t succ_idx;
      if (sit == by_id.end()) {
        // synthesize a del op (group_change_ops, columnar.js:876-943)
        const XOp &self = pool[size_t(pool_idx)];
        XOp del;
        del.ctr = sc;
        del.actor = sa;
        del.action = 3;
        del.obj_ctr = self.obj_ctr;
        del.obj_actor = self.obj_actor;
        if (self.key_kind == 0) {
          del.key_kind = 0;
          del.key_str = self.key_str;
        } else {
          del.key_kind = 2;
          if (self.insert) {
            del.ek_ctr = self.ctr;
            del.ek_actor = self.actor;
          } else if (self.key_kind == 2) {
            del.ek_ctr = self.ek_ctr;
            del.ek_actor = self.ek_actor;
          } else {
            return false;   // _head referent on a non-insert op
          }
        }
        pool.push_back(std::move(del));
        succ_idx = int32_t(pool.size() - 1);
        by_id.emplace(idkey(sc, sa), succ_idx);
      } else {
        succ_idx = sit->second;
      }
      pool[size_t(succ_idx)].pred.emplace_back(
          pool[size_t(pool_idx)].ctr, pool[size_t(pool_idx)].actor);
    }
  }
  if (raw_pos != raw_len || succ_pos != succ_total) return false;

  // assign every op (incl. synthesized dels) to its change by binary
  // search over the actor's maxOp sequence
  for (size_t pi = 0; pi < pool.size(); pi++) {
    const XOp &op = pool[pi];
    auto ait = by_actor.find(op.actor);
    if (ait == by_actor.end()) return false;
    std::vector<int32_t> &list = ait->second;
    size_t lo = 0, hi = list.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (changes[size_t(list[mid])].max_op < op.ctr) lo = mid + 1;
      else hi = mid;
    }
    if (lo >= list.size()) return false;   // opId outside allowed range
    changes[size_t(list[lo])].ops.push_back(int32_t(pi));
  }
  for (XChange &ch : changes) {
    std::sort(ch.ops.begin(), ch.ops.end(), [&](int32_t x, int32_t y) {
      return pool[size_t(x)].ctr < pool[size_t(y)].ctr;
    });
    int64_t start_op = ch.max_op - int64_t(ch.ops.size()) + 1;
    for (size_t k = 0; k < ch.ops.size(); k++)
      if (pool[size_t(ch.ops[k])].ctr != start_op + int64_t(k))
        return false;                 // non-contiguous opIds in a change
  }

  // ---- encode canonically, in document order; verify heads ----
  std::vector<uint8_t> is_head(n_changes, 1);
  for (size_t i = 0; i < n_changes; i++) {
    for (int64_t di : changes[i].deps_idx) is_head[size_t(di)] = 0;
    if (!encode_extracted_change(changes[i], pool, actors, keys, msgs, vals,
                                 changes, doc))
      return false;
  }
  std::vector<std::string> got_heads, want_heads;
  for (size_t i = 0; i < n_changes; i++)
    if (is_head[i])
      got_heads.emplace_back((const char *)changes[i].hash, 32);
  for (const uint8_t *h : heads)
    want_heads.emplace_back((const char *)h, 32);
  std::sort(got_heads.begin(), got_heads.end());
  std::sort(want_heads.begin(), want_heads.end());
  if (got_heads != want_heads) return false;
  doc.ok = 1;
  return true;
}

static std::vector<DocExtract> *g_extract = nullptr;

}  // namespace

extern "C" {

// Extract a batch of document chunks into canonical per-change chunks +
// hashes. Returns the total change count across extracted docs, or -1 on
// allocation-level failure. Per-doc failures set ok=0 (caller falls back
// per doc). Docs are independent, so the batch fans over the native pool
// with byte-identical output at every width.
int64_t am_extract_changes(const uint8_t *blob, const uint64_t *offsets,
                           const uint64_t *lens, uint64_t n_docs) {
  delete g_extract;
  g_extract = new std::vector<DocExtract>(n_docs);
  std::vector<DocExtract> &docs = *g_extract;
  int threads = NativePool::inst().threads();
  auto one = [&](int t, int) {
    DocExtract &d = docs[size_t(t)];
    if (!extract_document_body(blob + offsets[t], lens[t], d)) {
      DocExtract fresh;
      d = std::move(fresh);           // discard partial output
    }
  };
  if (threads > 1 && n_docs >= 2) {
    NativePool::inst().run(int(n_docs), one);
  } else {
    for (uint64_t i = 0; i < n_docs; i++) one(int(i), 0);
  }
  int64_t total = 0;
  for (auto &d : docs) total += int64_t(d.lens.size());
  return total;
}

// Sizes for fetch-buffer allocation. Returns 0, or -1 with no context.
int64_t am_extract_sizes(int64_t *total_changes, int64_t *blob_bytes) {
  if (!g_extract) return -1;
  int64_t tc = 0, tb = 0;
  for (auto &d : *g_extract) {
    tc += int64_t(d.lens.size());
    tb += int64_t(d.blob.size());
  }
  *total_changes = tc;
  *blob_bytes = tb;
  return 0;
}

// Copy out: ok [n_docs], d_off [n_docs+1] (per-doc first change index),
// c_off [C+1] (per-change byte offsets into blob), blob, hashes [32*C],
// max_ops [C]. Returns C and frees the context.
int64_t am_extract_fetch(uint8_t *ok, int64_t *d_off, int64_t *c_off,
                         uint8_t *blob, uint8_t *hashes, int64_t *max_ops) {
  if (!g_extract) return -1;
  std::vector<DocExtract> &docs = *g_extract;
  int64_t ci = 0, bpos = 0;
  for (size_t d = 0; d < docs.size(); d++) {
    ok[d] = docs[d].ok;
    d_off[d] = ci;
    for (size_t k = 0; k < docs[d].lens.size(); k++) {
      c_off[ci] = bpos;
      max_ops[ci] = docs[d].max_ops[k];
      bpos += docs[d].lens[k];
      ci++;
    }
    copy_bytes(blob + (bpos - int64_t(docs[d].blob.size())),
           docs[d].blob.data(), docs[d].blob.size());
    copy_bytes(hashes + 32 * (ci - int64_t(docs[d].lens.size())),
           docs[d].hashes.data(), docs[d].hashes.size());
  }
  d_off[docs.size()] = ci;
  c_off[ci] = bpos;
  delete g_extract;
  g_extract = nullptr;
  return ci;
}

}  // extern "C"
