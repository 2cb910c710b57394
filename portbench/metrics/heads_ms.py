"""Host time of the batch entry's head-frontier write (fleet/backend.py
`_apply_changes_turbo_inner`: the `turbo_heads` span inside
`turbo_commit`, the gate's end frontiers scattered into the fleet's head
lanes), in ms per timed batch."""

from .spans_util import total_ms


def read(ctx, name):
    if not ctx['steps']:
        return None
    ms = total_ms(ctx['spans'], ('turbo_heads',))
    return ms / ctx['steps'] if ms else None
