# Frozen copy of automerge_tpu_torch/common.py (whole file), kept here so
# that a change to the program cannot move the benchmark's inputs.
"""Shared helpers (ref src/common.js, src/uuid.js)."""

import uuid as _uuid


def parse_op_id(op_id):
    """Parse 'counter@actorId' into (counter, actor_id) (ref src/common.js:32-38)."""
    counter, sep, actor_id = op_id.partition('@')
    if not sep or not counter.isdigit():
        # archlint: ok[typed-errors] internal funnel helper like columnar/encoding: every wire path reaching it sits under a converting as_wire_error boundary (fuzz-enforced by tools/fuzz_wire.py)
        raise ValueError(f'Not a valid opId: {op_id}')
    return int(counter), actor_id


def compare_op_ids(a, b):
    """Lamport order on 'counter@actor' strings: by counter, then actorId."""
    ac, aa = parse_op_id(a)
    bc, ba = parse_op_id(b)
    if ac != bc:
        return -1 if ac < bc else 1
    if aa != ba:
        return -1 if aa < ba else 1
    return 0


def lamport_key(op_id):
    """Sort key giving ascending Lamport order for 'counter@actor' opIds."""
    counter, actor = parse_op_id(op_id)
    return (counter, actor)


_uuid_factory = None


def set_uuid_factory(factory):
    """Override uuid generation, e.g. for deterministic tests (ref src/uuid.js:13)."""
    global _uuid_factory
    _uuid_factory = factory


def uuid():
    if _uuid_factory is not None:
        return _uuid_factory()
    return _uuid.uuid4().hex
