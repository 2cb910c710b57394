"""Host time of the turnover between batches (fleet/backend.py
`free_docs`, fleet/loader.py `load_docs`: the `free_docs` and
`bulk_load` spans), in ms per timed batch."""

from .spans_util import total_ms


def read(ctx, name):
    if not ctx['steps']:
        return None
    ms = total_ms(ctx['spans'], ('free_docs', 'bulk_load'))
    return ms / ctx['steps'] if ms else None
