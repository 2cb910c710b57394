"""Differential tests of the port's batched sync plane
(fleet/sync_driver.py over fleet/bloom.py and fleet/hashindex.py)
against the JAX package's, in LWW mode (and in exact-device mode for
the fabric rounds), on the same change bytes.

Every generated message must be byte-identical to the reference's, round
after round: doc pairs syncing both ways until they converge (the
scenario of tests/test_sync_driver.py), and a fleet serving several peer
links per doc with a mid-round disconnect whose peer lost its replica
and a reset reconnect whose peer kept it (tests/test_sync_fabric.py).
A steady round costs one hash-index and one Bloom dispatch whatever the
link count, as in the reference; a receive drops an already-applied
change before the apply exactly as the reference does; the full-resync
reset frame matches. The mixed live/parked rounds over a StorageEngine
(the reference's TestParkedGate shapes) keep quiet parked docs parked,
revive exactly the doc a divergent peer needs, and leave storage whole
on a deadline abort, with messages, states and patches equal to the
reference's. The port's fleets run on the CPU (device='cpu'), where
every kernel is its plain version."""

import types

import pytest
import torch

import automerge_tpu.native as jax_native
import automerge_tpu_torch.native as torch_native
from automerge_tpu import backend as jax_host
from automerge_tpu import errors as jax_errors
from automerge_tpu.columnar import decode_change_meta, encode_change
from automerge_tpu.fleet import backend as jax_fleet
from automerge_tpu.fleet import bloom as jax_bloom
from automerge_tpu.fleet import hashindex as jax_hi
from automerge_tpu.fleet import storage as jax_storage
from automerge_tpu.fleet import sync_driver as jax_driver
from automerge_tpu.observability import health_counts as jax_health
from automerge_tpu.observability import spans as jax_spans
from automerge_tpu.observability import tracecontext as jax_tc
from automerge_tpu_torch import backend as torch_host
from automerge_tpu_torch import errors as torch_errors
from automerge_tpu_torch.fleet import backend as torch_fleet
from automerge_tpu_torch.fleet import bloom as torch_bloom
from automerge_tpu_torch.fleet import hashindex as torch_hi
from automerge_tpu_torch.fleet import sync_driver as torch_driver
from automerge_tpu_torch.fleet import storage as torch_storage
from automerge_tpu_torch.fleet import sync_kernels
from automerge_tpu_torch.observability import health_counts as torch_health
from automerge_tpu_torch.observability import spans as torch_spans
from automerge_tpu_torch.observability import tracecontext as torch_tc

# The tests' tensors are small: torch's intra-op thread pool costs far more
# than it saves on them (~10x a scan column on the CPU), and more again
# when test workers share the cores.
torch.set_num_threads(1)


REF = types.SimpleNamespace(name='jax', host=jax_host, fleet=jax_fleet,
                            driver=jax_driver, hi=jax_hi, bloom=jax_bloom,
                            kw={})
PORT = types.SimpleNamespace(name='torch', host=torch_host, fleet=torch_fleet,
                             driver=torch_driver, hi=torch_hi,
                             bloom=torch_bloom, kw={'device': 'cpu'})


@pytest.fixture(autouse=True)
def _codecs():
    """The fleet docs ride the turbo path, so both codecs must load; a
    reference codec that failed to build (a concurrent build of the
    reference's library) skips instead of failing the comparison."""
    if not (jax_native.available() and torch_native.available()):
        pytest.skip('a native codec is unavailable (the turbo path and '
                    'the reference comparison need both)')


def _change(actor, seq, start_op, deps, key, val):
    return encode_change({
        'actor': actor, 'seq': seq, 'startOp': start_op, 'time': 0,
        'message': '', 'deps': list(deps),
        'ops': [{'action': 'set', 'obj': '_root', 'key': key,
                 'value': val, 'datatype': 'int', 'pred': []}]})


def _chain(actor, n, deps=(), key='k', start_op=1, start_seq=1):
    bufs, deps = [], list(deps)
    for i in range(n):
        buf = _change(actor, start_seq + i, start_op + i, deps, f'{key}{i}',
                      i)
        deps = [decode_change_meta(buf, True)['hash']]
        bufs.append(buf)
    return bufs


def _fleet_docs(pkg, rows, device_min=1, exact=False):
    fleet = pkg.fleet.DocFleet(doc_capacity=max(len(rows), 8),
                               key_capacity=16, exact_device=exact, **pkg.kw)
    docs = pkg.fleet.init_docs(len(rows), fleet)
    docs, _ = pkg.fleet.apply_changes_docs(docs, rows, mirror=False)
    fleet.frontier_index(device_min=device_min)
    return fleet, docs


def _msgs(msgs):
    return [None if m is None else bytes(m) for m in msgs]


# ---- receive dedup and the reset frame ------------------------------------

def _dedup_receive(pkg):
    rows = [_chain(f'{d + 1:02x}' * 16, 3) for d in range(2)]
    fleet, docs = _fleet_docs(pkg, rows, device_min=None)
    fresh = _change('ee' * 16, 1, 50, list(docs[0]['heads']), 'fresh', 7)
    msg = pkg.host.encode_sync_message({
        'heads': [decode_change_meta(fresh, True)['hash']], 'need': [],
        'have': [], 'changes': [rows[0][0], fresh]})   # known + new
    states = [pkg.host.init_sync_state() for _ in docs]
    new_docs, new_states, _p = pkg.driver.receive_sync_messages_docs(
        docs, states, [msg, None])
    return (sorted(new_docs[0]['heads']), bytes(new_docs[0]['state'].save()),
            fleet.metrics.turbo_commit_fallback_docs,
            new_states[0]['sharedHeads'])


def test_receive_dedups_a_known_change_like_the_reference():
    got = _dedup_receive(PORT)
    assert got == _dedup_receive(REF)
    assert got[2] == 0              # the resent change never hit the gate


def _reset_frame(pkg):
    rows = [_chain(f'{d + 1:02x}' * 16, 3) for d in range(2)]
    _fleet, docs = _fleet_docs(pkg, rows)
    hashes = [[decode_change_meta(b, True)['hash'] for b in row]
              for row in rows]
    states = [pkg.host.init_sync_state() for _ in docs]
    states[0].update(theirHeads=[hashes[0][-1]], theirNeed=[],
                     theirHave=[{'lastSync': [hashes[0][0]], 'bloom': b''}])
    bogus = 'ab' * 32
    states[1].update(theirHeads=[bogus], theirNeed=[],
                     theirHave=[{'lastSync': [bogus], 'bloom': b''}])
    _s, msgs = pkg.driver.generate_sync_messages_docs(docs, states)
    return _msgs(msgs)


def test_reset_frame_matches_reference():
    got = _reset_frame(PORT)
    assert got == _reset_frame(REF)
    m1 = torch_host.decode_sync_message(got[1])
    assert m1['have'] == [{'lastSync': [], 'bloom': b''}]
    assert m1['changes'] == []


# ---- dispatches per steady round -----------------------------------------

def _solicit(states):
    for s in states:
        s['theirHeads'] = []
        s['theirHave'] = [{'lastSync': [], 'bloom': b''}]
        s['theirNeed'] = []


def _steady_round_dispatches(pkg, n_links):
    rows = [_chain('e0' * 16, 3)]
    _fleet, docs = _fleet_docs(pkg, rows)
    flat = [docs[0]] * n_links
    states = [pkg.host.init_sync_state() for _ in range(n_links)]
    # the cold round sends everything and stages every link's sent set;
    # the next round lands the staged sets (one insert) before it probes
    for _ in range(2):
        _solicit(states)
        states, msgs = pkg.driver.generate_sync_messages_docs(flat, states)
        assert all(m is not None for m in msgs)
    _solicit(states)
    h0, b0 = pkg.hi.dispatch_count(), pkg.bloom.dispatch_count()
    launches = dict(sync_kernels.LAUNCHES)
    states, msgs = pkg.driver.generate_sync_messages_docs(flat, states)
    assert sync_kernels.LAUNCHES == launches       # plain versions on CPU
    return (pkg.hi.dispatch_count() - h0,
            pkg.bloom.dispatch_count() - b0), _msgs(msgs)


@pytest.mark.parametrize('n_links', [16, 256])
def test_steady_round_is_one_index_and_one_bloom_dispatch(n_links):
    got, got_msgs = _steady_round_dispatches(PORT, n_links)
    want, want_msgs = _steady_round_dispatches(REF, n_links)
    assert got == want == (1, 1)
    assert got_msgs == want_msgs


# ---- doc pairs converging both ways (tests/test_sync_driver.py:40) -------

def _pair_rows(n_docs):
    a_rows, b_rows = [], []
    for d in range(n_docs):
        a = _chain(f'{d:02x}' * 8 + 'aa' * 8, 1 + d % 3, key='x')
        own = 'bb' * 8 + f'{d:02x}' * 8
        if d % 2:      # b holds a's history and builds on it
            b = a + _chain(own, d % 4, [decode_change_meta(a[-1], True)[
                'hash']], key='y', start_op=len(a) + 1)
        else:
            b = _chain(own, d % 4, key='y')
        a_rows.append(a)
        b_rows.append(b)
    return a_rows, b_rows


def _pair_transcript(pkg, a_rows, b_rows, rounds=4):
    _fa, side_a = _fleet_docs(pkg, a_rows)
    _fb, side_b = _fleet_docs(pkg, b_rows)
    init = pkg.host.init_sync_state
    sa = [init() for _ in a_rows]
    sb = [init() for _ in b_rows]
    out, disp = [], []
    for _ in range(rounds):
        h0, b0 = pkg.hi.dispatch_count(), pkg.bloom.dispatch_count()
        sa, ab = pkg.driver.generate_sync_messages_docs(side_a, sa)
        side_b, sb, _ = pkg.driver.receive_sync_messages_docs(side_b, sb, ab)
        sb, ba = pkg.driver.generate_sync_messages_docs(side_b, sb)
        side_a, sa, _ = pkg.driver.receive_sync_messages_docs(side_a, sa, ba)
        out.append((_msgs(ab), _msgs(ba)))
        disp.append((pkg.hi.dispatch_count() - h0,
                     pkg.bloom.dispatch_count() - b0))
    heads = [(sorted(a['heads']), sorted(b['heads']))
             for a, b in zip(side_a, side_b)]
    saves = [bytes(d['state'].save()) for d in side_a + side_b]
    return out, disp, heads, saves


def test_pairs_converge_with_messages_identical_to_reference():
    a_rows, b_rows = _pair_rows(4)
    want = _pair_transcript(REF, a_rows, b_rows)
    got = _pair_transcript(PORT, a_rows, b_rows)
    assert got[0] == want[0]            # every message, every round
    assert got[1] == want[1]            # dispatches per round
    assert got[2] == want[2] and got[3] == want[3]
    assert all(a == b for a, b in got[2])            # converged
    assert any(m is not None for m in got[0][0][0])  # real traffic


# ---- a fleet serving peer links (tests/test_sync_fabric.py:189) ----------

def _drive_links(pkg, fused, n=3, k=3, rounds=5, exact=False):
    """n fleet docs, k host peers per doc, `rounds` full rounds. Round 2:
    link (0, 1) drops and its peer comes back with NO replica (fresh
    states both ends, full resend through a new peer-space). Round 3:
    link (2, 0) resets both sync states but the peer keeps its data.
    Returns the byte transcript, the final heads and the sync states
    (with k = 1 there is no link (0, 1) to drop)."""
    doc_rows = [_chain(f'{i:02x}' * 16, 2, key=f'd{i}_') for i in range(n)]
    _fleet, docs = _fleet_docs(pkg, doc_rows, exact=exact)
    host, init = pkg.host, pkg.host.init_sync_state
    peers = [[host.apply_changes(host.init(), [_change(
        f'{0xa0 + i:02x}{j:02x}' * 8, 1, 1, [], f'p{i}_{j}', 100 * i + j)])[0]
        for j in range(k)] for i in range(n)]
    states = [[init() for _ in range(k)] for _ in range(n)]
    peer_states = [[init() for _ in range(k)] for _ in range(n)]
    transcript = []
    for r in range(rounds):
        if r == 2 and k > 1:
            pkg.hi.release_sync_state(states[0][1])
            states[0][1], peers[0][1] = init(), host.init()
            peer_states[0][1] = init()
        if r == 3:
            pkg.hi.release_sync_state(states[2][0])
            states[2][0], peer_states[2][0] = init(), init()
        if fused:
            flat_states, flat_msgs = pkg.driver.generate_sync_messages_docs(
                [docs[i] for i in range(n) for _ in range(k)],
                [states[i][j] for i in range(n) for j in range(k)])
            out = [[None] * k for _ in range(n)]
            for idx, (state, msg) in enumerate(zip(flat_states, flat_msgs)):
                i, j = divmod(idx, k)
                states[i][j], out[i][j] = state, msg
        else:
            out = [[None] * k for _ in range(n)]
            for i in range(n):
                for j in range(k):
                    states[i][j], out[i][j] = host.generate_sync_message(
                        docs[i], states[i][j])
        transcript.append([_msgs(row) for row in out])
        replies = [[None] * k for _ in range(n)]
        for i in range(n):
            for j in range(k):
                if out[i][j] is not None:
                    peers[i][j], peer_states[i][j], _ = \
                        host.receive_sync_message(peers[i][j],
                                                  peer_states[i][j],
                                                  out[i][j])
                peer_states[i][j], replies[i][j] = \
                    host.generate_sync_message(peers[i][j],
                                               peer_states[i][j])
        transcript.append([_msgs(row) for row in replies])
        for j in range(k):            # receive in waves over distinct docs
            wave = [i for i in range(n) if replies[i][j] is not None]
            if not wave:
                continue
            if fused:
                new_docs, new_states, _p = \
                    pkg.driver.receive_sync_messages_docs(
                        [docs[i] for i in wave],
                        [states[i][j] for i in wave],
                        [replies[i][j] for i in wave])
                for i, doc, state in zip(wave, new_docs, new_states):
                    docs[i], states[i][j] = doc, state
            else:
                for i in wave:
                    docs[i], states[i][j], _ = host.receive_sync_message(
                        docs[i], states[i][j], replies[i][j])
    heads = [sorted(d['heads']) for d in docs] + \
        [sorted(host.get_heads(p)) for row in peers for p in row]
    return transcript, heads, states


def test_fabric_rounds_with_disconnect_and_reset_match_reference():
    want, want_heads, _ = _drive_links(REF, fused=True)
    got, got_heads, states = _drive_links(PORT, fused=True)
    assert got == want
    assert got_heads == want_heads
    classic, classic_heads, _ = _drive_links(PORT, fused=False)
    assert got == classic and got_heads == classic_heads
    # every link that sent since its last reset rides a peer-space of its
    # own; the link reset with its data kept had nothing left to send
    sent = [s['sentHashes'] for row in states for s in row]
    spaces = [s for s in sent if isinstance(s, torch_hi.PeerSentSet)]
    assert len(spaces) == len(sent) - 1
    assert states[2][0]['sentHashes'] == set()
    assert len({s.sid for s in spaces}) == len(spaces)
    assert states[0][1]['sentHashes'].sid >= len(sent)   # a fresh space


def test_fabric_rounds_in_exact_mode_match_reference():
    """The same rounds over exact-device fleets (the register engine
    behind the docs), as tests/test_sync_fabric.py runs its 'exact'
    mode, with one peer per doc (so no disconnect; the reset reconnect
    stays): every message and the final heads equal the reference's."""
    want, want_heads, _ = _drive_links(REF, fused=True, k=1, rounds=4,
                                       exact=True)
    got, got_heads, _ = _drive_links(PORT, fused=True, k=1, rounds=4,
                                     exact=True)
    assert got == want
    assert got_heads == want_heads


# ---- the mixed live/parked rounds (the parked gate) ------------------------
#
# The shapes of the reference's tests/test_sync_driver.py TestParkedGate:
# fleet docs synced to quiescence with host peers, parked in a
# StorageEngine, then driven through generate/receive_sync_messages_mixed.
# Messages, states, patches, which docs revive and the
# storage_parked_syncs_skipped deltas must equal the reference's.

def _with_storage(pkg):
    """The storage tier, health counters, trace context, spans and
    errors of `pkg`'s package."""
    if pkg is REF:
        return types.SimpleNamespace(S=jax_storage, health=jax_health,
                                     tc=jax_tc, spans=jax_spans,
                                     errors=jax_errors)
    return types.SimpleNamespace(S=torch_storage, health=torch_health,
                                 tc=torch_tc, spans=torch_spans,
                                 errors=torch_errors)


class _Deadline:
    """The service's Deadline reduced to what the sync driver calls:
    `check(what=)` raises the package's DeadlineExceeded once the clock
    passes `at`."""

    def __init__(self, at, clock, errors):
        self.at, self.clock, self.errors = at, clock, errors

    def check(self, what='request'):
        late = self.clock() - self.at
        if late > 0:
            raise self.errors.DeadlineExceeded(
                f'{what}: deadline exceeded', deadline=self.at,
                late_by=late)
        return self


def _converged_population(pkg, n=6):
    """n (fleet doc, host peer) pairs driven to sync quiescence, with
    both sides' sync states."""
    fleet = pkg.fleet.DocFleet(**pkg.kw)
    docs = pkg.fleet.init_docs(n, fleet)
    heads = [[] for _ in range(n)]
    for r in range(3):
        per_doc = []
        for d in range(n):
            buf = _change(f'{d:04x}' * 4, r + 1, r + 1, heads[d], f'k{r}',
                          d * 10 + r)
            heads[d] = [decode_change_meta(buf, True)['hash']]
            per_doc.append([buf])
        docs, _ = pkg.fleet.apply_changes_docs(docs, per_doc, mirror=False)
    peers = [pkg.host.init() for _ in range(n)]
    ls = [pkg.host.init_sync_state() for _ in range(n)]
    ps = [pkg.host.init_sync_state() for _ in range(n)]
    for _ in range(10):
        traffic = False
        ls, msgs = pkg.driver.generate_sync_messages_docs(docs, ls)
        for i, m in enumerate(msgs):
            if m is not None:
                traffic = True
                peers[i], ps[i], _ = pkg.host.receive_sync_message(
                    peers[i], ps[i], m)
        replies = []
        for i in range(n):
            ps[i], back = pkg.host.generate_sync_message(peers[i], ps[i])
            replies.append(back)
            traffic = traffic or back is not None
        docs, ls, _ = pkg.driver.receive_sync_messages_docs(docs, ls,
                                                            replies)
        if not traffic:
            break
    for i in range(n):
        assert pkg.host.get_heads(peers[i]) == sorted(docs[i]['state'].heads)
    return fleet, docs, peers, ls, ps


def _views(states):
    """Sync states made comparable across packages: a peer-space
    sentHashes (each package's own PeerSentSet) reads as its space id,
    a plain set as its sorted members."""
    out = []
    for state in states:
        view = dict(state)
        sent = view.get('sentHashes')
        view['sentHashes'] = sorted(sent) if isinstance(sent, set) else \
            (type(sent).__name__, sent.sid)
        out.append(view)
    return out


def _skipped(x):
    return x.health()['storage_parked_syncs_skipped']


def _quiet_parked(pkg):
    x = _with_storage(pkg)
    fleet, docs, peers, ls, ps = _converged_population(pkg)
    eng = x.S.StorageEngine(fleet)
    ids = eng.park(docs)
    before = _skipped(x)
    out_docs, out_ls, msgs = pkg.driver.generate_sync_messages_mixed(
        eng, ids, ls)
    gen = (out_docs == ids, len(eng.main), out_ls == ls, msgs,
           _skipped(x) - before)
    peer_msgs = [pkg.host.generate_sync_message(
        p, dict(s, lastSentHeads=None))[1] for p, s in zip(peers, ps)]
    before = _skipped(x)
    out_docs, out_ls, patches = pkg.driver.receive_sync_messages_mixed(
        eng, ids, out_ls, peer_msgs)
    rec = (out_docs == ids, len(eng.main), _views(out_ls), patches,
           _skipped(x) - before,
           [sorted(s['theirHeads']) == eng.heads(ids[i])
            for i, s in enumerate(out_ls)])
    return ids, gen, rec


def test_quiet_parked_docs_stay_parked_like_the_reference():
    got = _quiet_parked(PORT)
    assert got == _quiet_parked(REF)
    ids, gen, rec = got
    assert gen[:3] == (True, 6, True) and gen[3] == [None] * 6
    assert gen[4] == 6 and rec[:2] == (True, 6) and rec[4] == 6
    assert all(rec[5])


def _enveloped(pkg):
    x = _with_storage(pkg)
    fleet, docs, peers, ls, ps = _converged_population(pkg)
    eng = x.S.StorageEngine(fleet)
    ids = eng.park(docs)
    peer_msgs = [pkg.host.generate_sync_message(
        p, dict(s, lastSentHeads=None))[1] for p, s in zip(peers, ps)]
    ctxs = [x.tc.mint() for _ in peer_msgs]
    wrapped = [x.tc.wrap(m, c) for m, c in zip(peer_msgs, ctxs)]
    x.spans.enable()
    x.spans.clear()
    try:
        out_docs, out_ls, patches = pkg.driver.receive_sync_messages_mixed(
            eng, ids, ls, wrapped)
        spans = {s['name']: s for s in x.spans.iter_spans()}
    finally:
        x.spans.disable()
    adopted = spans['sync_parked_gate']['attrs']['trace'] == \
        ctxs[0].trace_id
    return out_docs == ids, _views(out_ls), patches, adopted


def test_enveloped_messages_pass_the_parked_gate_like_the_reference():
    got = _enveloped(PORT)
    assert got == _enveloped(REF)
    assert got[0] and got[3]


def _divergent(pkg):
    x = _with_storage(pkg)
    fleet, docs, peers, ls, ps = _converged_population(pkg)
    n = len(docs)
    eng = x.S.StorageEngine(fleet)
    ids = eng.park(docs)
    edit = _change('dd' * 16, 1, 100, pkg.host.get_heads(peers[2]), 'new', 1)
    peers[2], _ = pkg.host.apply_changes(peers[2], [edit])
    mixed = list(ids)
    log = []
    for _ in range(10):
        traffic = False
        replies = []
        for i in range(n):
            ps[i], back = pkg.host.generate_sync_message(peers[i], ps[i])
            replies.append(back)
            traffic = traffic or back is not None
        mixed, ls, patches = pkg.driver.receive_sync_messages_mixed(
            eng, mixed, ls, replies)
        mixed, ls, msgs = pkg.driver.generate_sync_messages_mixed(
            eng, mixed, ls)
        log.append((_msgs(replies), patches, _msgs(msgs), _views(ls)))
        for i, m in enumerate(msgs):
            if m is not None:
                traffic = True
                peers[i], ps[i], _ = pkg.host.receive_sync_message(
                    peers[i], ps[i], m)
        if not traffic:
            break
    return ([isinstance(d, int) for d in mixed], len(eng.main), log,
            sorted(mixed[2]['state'].heads) == pkg.host.get_heads(peers[2]),
            bytes(mixed[2]['state'].save()))


def test_divergent_peer_revives_only_its_doc_like_the_reference():
    got = _divergent(PORT)
    assert got == _divergent(REF)
    parked, stored, _log, converged, _save = got
    assert parked == [i != 2 for i in range(6)] and stored == 5
    assert converged


def _deadline_abort(pkg):
    x = _with_storage(pkg)
    fleet, docs, peers, ls, ps = _converged_population(pkg, 3)
    eng = x.S.StorageEngine(fleet)
    ids = eng.park(docs)
    heads_before = [eng.heads(i) for i in ids]
    fresh = [dict(s, theirHeads=None) for s in ls]
    out = []
    with pytest.raises(x.errors.DeadlineExceeded):
        pkg.driver.generate_sync_messages_mixed(
            eng, ids, fresh, deadline=_Deadline(-1.0, lambda: 0.0, x.errors))
    out.append(len(eng.main))
    ticks = [0.0]

    def clock():
        ticks[0] += 1.0
        return ticks[0]
    with pytest.raises(x.errors.DeadlineExceeded):
        pkg.driver.generate_sync_messages_mixed(
            eng, ids, fresh, deadline=_Deadline(1.5, clock, x.errors))
    out.append(len(eng.main))
    out.append([eng.heads(i) == h for i, h in zip(ids, heads_before)])
    out.append(sorted(eng._row_of) == sorted(ids))
    return out


def test_deadline_abort_leaves_storage_whole_like_the_reference():
    got = _deadline_abort(PORT)
    assert got == _deadline_abort(REF)
    assert got == [3, 3, [True] * 3, True]


# ---- the shard cluster's pair reset ----------------------------------------

@pytest.mark.parametrize('pkg', [REF, PORT], ids=lambda p: p.name)
def test_cluster_pair_reset_releases_both_spaces(pkg):
    """tests/test_sync_fabric.py's cluster pair reset, through each
    package's shard cluster: a replica pair's reset hands both of its
    peer spaces back to the index at once and starts the pair over with
    plain sent sets and empty inboxes."""
    import importlib
    cluster = importlib.import_module(
        pkg.fleet.__name__.replace('.fleet.backend', '.shard.cluster'))
    ix = pkg.hi.HashIndex(capacity=16, device_min=1, **pkg.kw)
    a = pkg.hi.PeerSentSet(ix)
    b = pkg.hi.PeerSentSet(ix)
    a.add('ab' * 32)
    a.flush()

    class _Rec:
        pass

    rec = _Rec()
    rec.state_home = dict(pkg.host.init_sync_state(), sentHashes=a)
    rec.state_rep = dict(pkg.host.init_sync_state(), sentHashes=b)
    cluster._Tenant._reset_pair(rec)
    assert not a.alive and not b.alive
    assert not ix._live[a.sid] and not ix._live[b.sid]
    assert isinstance(rec.state_home['sentHashes'], set)
    assert isinstance(rec.state_rep['sentHashes'], set)
    assert rec.inbox_home == [] and rec.inbox_rep == []
