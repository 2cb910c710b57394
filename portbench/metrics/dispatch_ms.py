"""Host time of the dispatch layer (fleet/backend.py `_dispatch_grid`,
`_dispatch_seq`: the `dispatch_grid` and `dispatch_seq` spans), in ms per
timed batch."""

from .spans_util import total_ms


def read(ctx, name):
    if not ctx['steps']:
        return None
    ms = total_ms(ctx['spans'], ('dispatch_grid', 'dispatch_seq'))
    return ms / ctx['steps'] if ms else None
