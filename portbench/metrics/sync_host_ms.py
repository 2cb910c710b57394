"""Host time of the sync round (fleet/sync_driver.py: the self time of
its `sync_receive`, `sync_decode`, `sync_generate` and `sync_encode`
spans, without the spans nested inside them), in ms per round."""

from .spans_util import self_ms


def read(ctx, name):
    if not ctx['steps']:
        return None
    ms = self_ms(ctx['spans'], ('sync_receive', 'sync_decode',
                                'sync_generate', 'sync_encode'))
    return ms / ctx['steps'] if ms else None
