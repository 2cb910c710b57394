"""The comparison that decides `correct` fails what it must: the control
(the reference with one broken guarantee in the program's place), and
the whole run driven with the timed path broken underneath: a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced. (The cells run on one chip: there is no
exchange between chips to leave out.)"""

import pytest

import automerge_tpu_torch.fleet.backend as fb
import automerge_tpu_torch.fleet.sync_driver as sd
from helpers import CELLS, run_tiny

BATCH_CELLS = ('map-batch-10k', 'text-batch-1k')


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    result, checks = run_tiny(cell, control=True)
    assert not result['correct']
    assert max(v - lim for _n, v, lim in checks) > 0


@pytest.mark.parametrize('cell', BATCH_CELLS)
def test_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(fb, 'apply_changes_docs',
                        lambda handles, per_doc, **kw: (handles, None))
    result, _ = run_tiny(cell)
    assert not result['correct']


@pytest.mark.parametrize('cell', BATCH_CELLS)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    real = fb.apply_changes_docs

    def half(handles, per_doc, **kw):
        keep = len(per_doc) // 2
        return real(handles, per_doc[:keep] + [[]] * (len(per_doc) - keep),
                    **kw)
    monkeypatch.setattr(fb, 'apply_changes_docs', half)
    result, _ = run_tiny(cell)
    assert not result['correct']


def test_sync_round_that_answers_half_the_links(monkeypatch):
    real = sd.generate_sync_messages_docs

    def half(backends, states, **kw):
        states, msgs = real(backends, states, **kw)
        return states, msgs[:len(msgs) // 2] + [None] * (
            len(msgs) - len(msgs) // 2)
    monkeypatch.setattr(sd, 'generate_sync_messages_docs', half)
    result, _ = run_tiny('map-sync-20k')
    assert not result['correct']


def test_sync_round_that_keeps_no_state(monkeypatch):
    """The receive step returns the states unchanged: the hub then knows
    nothing of the peers' filters."""
    real = sd.receive_sync_messages_docs

    def unchanged(backends, states, msgs, **kw):
        new_backends, _states, patches = real(backends, states, msgs, **kw)
        return new_backends, states, patches
    monkeypatch.setattr(sd, 'receive_sync_messages_docs', unchanged)
    result, _ = run_tiny('map-sync-20k')
    assert not result['correct']


@pytest.mark.parametrize('cell', BATCH_CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    real = fb.materialize_docs

    def altered(handles):
        docs = real(handles)
        doc = dict(docs[len(docs) // 2])
        key = sorted(doc)[0]
        doc[key] = doc[key] + 1 if isinstance(doc[key], int) else \
            doc[key][:-1] + '?'
        docs[len(docs) // 2] = doc
        return docs
    monkeypatch.setattr(fb, 'materialize_docs', altered)
    result, checks = run_tiny(cell)
    assert not result['correct']
    assert dict((n, v) for n, v, _l in checks)['docs_wrong'] == 1


def test_service_that_never_applies(monkeypatch):
    """The service's fused apply returns its docs unchanged: the edits'
    tickets resolve, and the docs read back lack them."""
    import automerge_tpu_torch.service.core as core
    monkeypatch.setattr(core.fleet_backend, 'apply_changes_docs',
                        lambda handles, per_doc, **kw:
                        (handles, [None] * len(handles), [None] * len(handles))
                        if kw.get('on_error') == 'quarantine'
                        else (handles, [None] * len(handles)))
    result, _ = run_tiny('map-service-10k')
    assert not result['correct']


def test_service_edit_altered_where_read(monkeypatch):
    real = fb.materialize_docs

    def altered(handles):
        docs = real(handles)
        i = next(i for i, d in enumerate(docs) if d)
        doc = dict(docs[i])
        key = sorted(doc)[0]
        doc[key] += 1
        docs[i] = doc
        return docs
    monkeypatch.setattr(fb, 'materialize_docs', altered)
    result, checks = run_tiny('map-service-10k')
    assert not result['correct']
    assert dict((n, v) for n, v, _l in checks)['docs_wrong'] == 1


def test_reply_altered_where_produced(monkeypatch):
    real = sd.generate_sync_messages_docs

    def altered(backends, states, **kw):
        states, msgs = real(backends, states, **kw)
        m = bytearray(msgs[3])
        m[-1] ^= 1
        msgs[3] = bytes(m)
        return states, msgs
    monkeypatch.setattr(sd, 'generate_sync_messages_docs', altered)
    result, _ = run_tiny('map-sync-20k')
    assert not result['correct']
