"""Host time of the batch entry's causal gate (fleet/backend.py
`_apply_changes_turbo_inner`: the `turbo_causal` span, the native
causal-run gate and the frontier checks, and the `turbo_drain` span, the
host's general gate for the docs it sends there; both inside
`turbo_gate`), in ms per timed batch."""

from .spans_util import total_ms


def read(ctx, name):
    if not ctx['steps']:
        return None
    ms = total_ms(ctx['spans'], ('turbo_causal', 'turbo_drain'))
    return ms / ctx['steps'] if ms else None
