"""Host time of the batch entry's turbo apply (fleet/backend.py
`_apply_changes_turbo_inner`: its `turbo_setup`, `turbo_parse`,
`turbo_gate`, `turbo_commit` and `turbo_stage` spans), in ms per timed
batch."""

from .spans_util import total_ms

PHASES = ('turbo_setup', 'turbo_parse', 'turbo_gate', 'turbo_commit',
          'turbo_stage')


def read(ctx, name):
    if not ctx['steps']:
        return None
    ms = total_ms(ctx['spans'], PHASES)
    return ms / ctx['steps'] if ms else None
