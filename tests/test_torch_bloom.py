"""Differential tests of the port's Bloom filters (fleet/bloom.py and the
plain versions of its kernels in fleet/sync_kernels.py) against the JAX
package's fleet/bloom.py, on the same numpy-seeded hashes. Filter bytes
and probe answers must be equal, exactly: the flat packed build and
probe over skewed entry counts and empty rows, a filter with
nonstandard parameters (the host fallback), a corrupt filter (all-False
and one `rejected_filters` count), the uniform [N, B] pair, and the
uint32 wraparound of the triple hashing."""

import numpy as np
import pytest
import torch

from automerge_tpu.backend.sync import BloomFilter as JaxBloomFilter
from automerge_tpu.backend.sync import _wire_stats as jax_wire_stats
from automerge_tpu.fleet import bloom as jax_bloom
from automerge_tpu_torch.backend.sync import _wire_stats as torch_wire_stats
from automerge_tpu_torch.fleet import bloom as torch_bloom
from automerge_tpu_torch.fleet import sync_cases, sync_kernels

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


CPU = 'cpu'


def _hash_lists(seed, counts):
    rng = np.random.default_rng(seed)
    return [[rng.bytes(32).hex() for _ in range(c)] for c in counts]


# entry counts per row: skewed (1 to 300), with empty rows between, and
# the degenerate all-empty batch
COUNTS = {
    'skewed': [1, 300, 7, 0, 42, 0, 0, 150, 3, 64, 9, 0, 1, 2, 255],
    'one_row': [17],
    'all_empty': [0, 0, 0],
    'many_small': [2] * 40 + [0] * 9,
}


@pytest.mark.parametrize('case', sorted(COUNTS))
def test_flat_build_bytes_match_reference(case):
    lists = _hash_lists(1, COUNTS[case])
    want = jax_bloom.build_bloom_filters_batch(lists)
    before = dict(sync_kernels.LAUNCHES)
    got = torch_bloom.build_bloom_filters_batch(lists, device=CPU)
    assert got == want
    assert sync_kernels.LAUNCHES == before       # the CPU runs the plain
    # and the host protocol's own filter agrees byte for byte
    for row, fb in zip(lists, got):
        assert fb == (JaxBloomFilter(row).bytes if row else b'')


@pytest.mark.parametrize('case', sorted(COUNTS))
def test_flat_probe_matches_reference(case):
    lists = _hash_lists(2, COUNTS[case])
    filters = jax_bloom.build_bloom_filters_batch(lists)
    # half the probes are members, half are not (false positives too)
    rng = np.random.default_rng(3)
    probes = [row[:len(row) // 2] + [rng.bytes(32).hex()
                                      for _ in range(len(row) + 3)]
              for row in lists]
    want = jax_bloom.probe_bloom_filters_batch(filters, probes)
    got = torch_bloom.probe_bloom_filters_batch(filters, probes, device=CPU)
    assert got == want
    for row, hits in zip(lists, got):
        assert all(hits[:len(row) // 2])          # no false negatives


def test_dispatch_counts_track_the_reference():
    lists = _hash_lists(4, COUNTS['skewed'])
    j0, t0 = jax_bloom.dispatch_count(), torch_bloom.dispatch_count()
    filters = torch_bloom.build_bloom_filters_batch(lists, device=CPU)
    torch_bloom.probe_bloom_filters_batch(filters, lists, device=CPU)
    jax_bloom.probe_bloom_filters_batch(
        jax_bloom.build_bloom_filters_batch(lists), lists)
    assert torch_bloom.dispatch_count() - t0 == 2
    assert jax_bloom.dispatch_count() - j0 == 2


def test_nonstandard_filter_takes_the_host_fallback():
    lists = _hash_lists(5, [30, 12, 5])
    filters = jax_bloom.build_bloom_filters_batch(lists)
    odd = JaxBloomFilter(lists[1])
    odd.num_bits_per_entry, odd.num_probes = 12, 5
    odd.bits = bytearray((len(lists[1]) * 12 + 7) // 8)
    for h in lists[1]:
        odd.add_hash(h)
    filters[1] = odd.bytes
    probes = [row + _hash_lists(6, [4])[0] for row in lists]
    want = jax_bloom.probe_bloom_filters_batch(filters, probes)
    got = torch_bloom.probe_bloom_filters_batch(filters, probes, device=CPU)
    assert got == want
    assert all(got[1][:len(lists[1])])


def test_corrupt_filter_reads_all_false_and_is_counted():
    lists = _hash_lists(7, [20, 20])
    filters = jax_bloom.build_bloom_filters_batch(lists)
    filters[0] = filters[0][:5]                    # truncated bit payload
    j0 = jax_wire_stats['rejected_filters']
    t0 = torch_wire_stats['rejected_filters']
    want = jax_bloom.probe_bloom_filters_batch(filters, lists)
    got = torch_bloom.probe_bloom_filters_batch(filters, lists, device=CPU)
    assert got == want
    assert got[0] == [False] * 20 and all(got[1])
    assert torch_wire_stats['rejected_filters'] - t0 == 1
    assert jax_wire_stats['rejected_filters'] - j0 == 1


@pytest.mark.parametrize('num_entries', [1, 13, 200])
def test_uniform_build_and_probe_match_reference(num_entries):
    lists = _hash_lists(8, [num_entries, max(num_entries // 3, 1), 0, 5])
    words, valid = jax_bloom.hashes_to_words(lists)
    want = np.asarray(jax_bloom.build_bloom_filters(words, valid,
                                                    num_entries))
    got = torch_bloom.build_bloom_filters(words, valid, num_entries,
                                          device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    probe_words, probe_valid = jax_bloom.hashes_to_words(
        [row + _hash_lists(9, [6])[0] for row in lists])
    want_hit = np.asarray(jax_bloom.probe_bloom_filters(
        want, probe_words, probe_valid))
    got_hit = torch_bloom.probe_bloom_filters(got, probe_words, probe_valid)
    np.testing.assert_array_equal(got_hit.numpy(), want_hit)
    if num_entries == 13:
        assert torch_bloom.bloom_filter_bytes(got[0], 13) == \
            jax_bloom.bloom_filter_bytes(want[0], 13)


def test_plain_kernels_match_the_jax_kernels_at_padded_shapes():
    """sync_kernels' plain build/probe against bloom.py's jitted
    `_build_flat_packed` / `_probe_flat_packed` on the same padded
    arrays (the inputs the batched entry points hand them)."""
    rng = np.random.default_rng(10)
    rows, h = 16, 8
    words = rng.integers(0, 1 << 32, (rows, h, 3), dtype=np.uint64) \
        .astype(np.uint32)
    valid = rng.random((rows, h)) < 0.7
    row_bits = (8 * rng.integers(1, 40, rows)).astype(np.uint32)
    bit_off = np.cumsum(row_bits.astype(np.int64)) - row_bits
    total = 1 << int(np.ceil(np.log2(int(row_bits.sum()))))
    want = np.asarray(jax_bloom._build_flat_packed(
        words, valid, row_bits, bit_off, total))
    t = (torch.from_numpy(words.view(np.int32)), torch.from_numpy(valid),
         torch.from_numpy(row_bits.astype(np.int64)),
         torch.from_numpy(bit_off))
    got = sync_kernels.bloom_build(*t, total)
    np.testing.assert_array_equal(got.numpy(), want)
    byte_off = bit_off // 8
    want_hit = np.asarray(jax_bloom._probe_flat_packed(
        want, row_bits, byte_off, words, valid))
    got_hit = sync_kernels.bloom_probe(
        got, t[2], torch.from_numpy(byte_off), t[0], t[1])
    np.testing.assert_array_equal(got_hit.numpy(), want_hit)


@pytest.mark.parametrize('counts', ['skewed', 'uniform'])
def test_shared_bloom_cases_hold_on_the_cpu(counts):
    """The build-and-probe comparison the card tests and chip_smoke.py
    run (fleet/sync_cases.py), with the plain versions on both sides
    here: every member is found, and it launches nothing."""
    _shared_bloom_case_holds(counts)


@pytest.mark.parametrize('counts', ['padding', 'spanning', 'cta_edges'])
def test_shared_bloom_build_corners_hold_on_the_cpu(counts):
    """The same for the build kernel's corners (the card also runs
    'window_cap' and 'past_cap', too large for the plain build here)."""
    _shared_bloom_case_holds(counts)


def _shared_bloom_case_holds(counts):
    before = dict(sync_kernels.LAUNCHES)
    # the first 1,000 filters of each case (the card runs them all)
    sizes = sync_cases.BLOOM_COUNTS[counts][:1000]
    got = sync_cases.bloom_both(np.random.default_rng(43), sizes, CPU)
    assert (got['build'], got['probe'], got['missed']) == (0, 0, 0)
    assert got['filters'] == sum(1 for c in sizes if c)
    assert sync_kernels.LAUNCHES == before


@pytest.mark.parametrize('name', ['all_present', 'all_absent'])
def test_probe_corners_match_reference(name):
    """The probe kernel's new corners (fleet/sync_cases.py; the card also
    runs 'past_2_31', a 268 MB filter): every lane a member, every filter
    empty. The port's plain probe against JAX's `_probe_flat_packed` on
    the same inputs."""
    flat, row_bits, byte_off, words, valid = sync_cases.bloom_probe_case(
        name, np.random.default_rng(44), CPU)
    want = np.asarray(jax_bloom._probe_flat_packed(
        flat.numpy(), row_bits.numpy().astype(np.uint32), byte_off.numpy(),
        words.numpy().view(np.uint32), valid.numpy()))
    got = sync_kernels.bloom_probe(flat, row_bits, byte_off, words, valid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == (int(valid.sum()) if name == 'all_present'
                              else 0)


def test_probe_indexes_wrap_like_uint32():
    """Capacities near 2^32 make x + y pass 2^32: the plain version's
    int64 chain must wrap exactly as the JAX uint32 arithmetic does."""
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 32, (4, 64, 3), dtype=np.uint64) \
        .astype(np.uint32)
    row_bits = np.array([(1 << 32) - 8, 3_000_000_000, 2_147_483_656, 80],
                        dtype=np.uint32)
    want = np.asarray(jax_bloom._probe_indexes(words, row_bits[:, None]))
    got = sync_kernels.probe_indexes_plain(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(row_bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  want.view(np.uint32))
    assert (got.numpy() >= 1 << 31).any()          # the wrap was exercised


@pytest.mark.parametrize('m', [8, 80, 10_000, (1 << 31) - 8, 1 << 31,
                               3 << 30])
def test_stepped_probe_rule_matches_reference(m):
    """The build kernel's modulo rule (conditional subtraction while
    m <= 2^31, the uint32 modulo chain above) against JAX's
    `_probe_indexes` at capacities below, at and above 2^31 (whole
    bytes, as the reference's filters are)."""
    rng = np.random.default_rng(13)
    words = rng.integers(0, 1 << 32, (3, 256, 3), dtype=np.uint64) \
        .astype(np.uint32)
    row_bits = np.full(3, m, dtype=np.uint32)
    want = np.asarray(jax_bloom._probe_indexes(words, row_bits[:, None]))
    t = (torch.from_numpy(words.view(np.int32)),
         torch.from_numpy(row_bits.astype(np.int64)))
    got = sync_kernels.probe_indexes_stepped(*t)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(got, sync_kernels.probe_indexes_plain(*t))
    assert int(got.max()) < m


@pytest.mark.parametrize('counts', sorted(sync_cases.BLOOM_COUNTS))
def test_build_groups_cover_the_rows_once(counts):
    """The build kernel's split of the output (`bloom_groups_plain` at
    `bloom_plan`'s group) against the rows' byte spans: the CTAs' bytes
    cover the output once, in order; each live row lies whole inside its
    CTA's window bytes, and no row's byte lies in a CTA's zero part.
    Every case but 'past_cap' fits each CTA's window bytes in one
    shared-memory window."""
    row_bits, bit_off, total_bits, h = sync_cases.bloom_layout(
        sync_cases.BLOOM_COUNTS[counts])
    total = total_bits // 8
    group, window, ctas = sync_kernels.bloom_plan(len(row_bits), h)
    assert window % 16 == 0 and window <= sync_kernels.WINDOW_CAP
    own_lo, rows_end, own_hi = sync_kernels.bloom_groups_plain(
        bit_off, row_bits, total_bits, group)
    assert len(own_lo) == ctas
    assert int(own_lo[0]) == 0 and int(own_hi[-1]) == total
    assert torch.equal(own_lo[1:], own_hi[:-1])
    assert bool((own_lo <= rows_end).all() and (rows_end <= own_hi).all())
    starts, ends = bit_off // 8, (bit_off + row_bits) // 8
    live = starts < total
    assert bool((starts[live][1:] >= ends[live][:-1]).all())
    covered = torch.zeros(total, dtype=torch.int64)
    for r in torch.nonzero(live).flatten().tolist():
        c = r // group
        assert int(own_lo[c]) <= int(starts[r])
        assert int(ends[r]) <= int(rows_end[c])
        covered[int(starts[r]):int(ends[r])] += 1
    for c in range(ctas):
        assert int(covered[int(rows_end[c]):int(own_hi[c])].sum()) == 0
    assert int(covered.max()) == 1
    # one window holds a CTA's window bytes, from its 16-byte aligned start
    need = int((rows_end - (own_lo & ~15)).max())
    assert (need > window) == (counts == 'past_cap')


def test_kernel_wrappers_refuse_malformed_inputs():
    words = torch.zeros((2, 8, 3), dtype=torch.int32)
    valid = torch.ones((2, 8), dtype=torch.bool)
    bits = torch.full((2,), 80, dtype=torch.int64)
    offs = torch.tensor([0, 80], dtype=torch.int64)
    with pytest.raises(ValueError, match='words'):
        sync_kernels.bloom_build(words.long(), valid, bits, offs, 256)
    with pytest.raises(ValueError, match='row_bits'):
        sync_kernels.bloom_build(words, valid, bits.int(), offs, 256)
    with pytest.raises(ValueError, match='total_bits'):
        sync_kernels.bloom_build(words, valid, bits, offs, 200)
    with pytest.raises(ValueError, match='power of two'):
        sync_kernels.bloom_build(words[:, :6].contiguous(),
                                 valid[:, :6].contiguous(), bits, offs, 256)
    with pytest.raises(ValueError, match='valid'):
        sync_kernels.bloom_probe(torch.zeros(64, dtype=torch.uint8), bits,
                                 offs, words, valid[:, :4])
    with pytest.raises(ValueError, match='flat'):
        sync_kernels.bloom_probe(torch.zeros(64, dtype=torch.int32), bits,
                                 offs, words, valid)


def test_batched_entry_points_without_a_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    lists = _hash_lists(12, [3, 0])
    with pytest.raises(RuntimeError, match='CUDA'):
        torch_bloom.build_bloom_filters_batch(lists)
    # an all-empty batch dispatches nothing, so it needs no device
    assert torch_bloom.build_bloom_filters_batch([[], []]) == [b'', b'']
