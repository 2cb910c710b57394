"""Host time of the bulk load's per-row sequence value pass
(fleet/loader.py `_install_seq_rows`, from the grouping through the
value loop and the inexact flags: the `load_seq_values` phase of
`bulk_load`), in ms per timed batch."""

from .spans_util import total_ms


def read(ctx, name):
    if not ctx['steps']:
        return None
    ms = total_ms(ctx['spans'], ('load_seq_values',))
    return ms / ctx['steps'] if ms else None
