# The port's copy of tests/test_uuid.py, imports re-pointed at automerge_tpu_torch.
"""uuid helper tests (ported semantics of reference test/uuid_test.js)."""

import re

import automerge_tpu_torch as am
from automerge_tpu_torch.common import uuid, set_uuid_factory


class TestUuid:
    def test_generates_unique_values(self):
        a, b = uuid(), uuid()
        assert a != b
        assert re.fullmatch(r'[0-9a-f]{32}', a)

    def test_custom_factory(self):
        seq = iter(range(100))
        set_uuid_factory(lambda: f'custom-{next(seq)}')
        try:
            assert uuid() == 'custom-0'
            assert uuid() == 'custom-1'
        finally:
            set_uuid_factory(None)
        assert re.fullmatch(r'[0-9a-f]{32}', uuid())

    def test_factory_drives_actor_ids(self):
        set_uuid_factory(lambda: 'feedface')
        try:
            doc = am.init()
            assert am.get_actor_id(doc) == 'feedface'
        finally:
            set_uuid_factory(None)
