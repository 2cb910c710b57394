"""Host time of a service tick (service/core.py `DocService.pump`: the
`service_tick` span), in ms per tick of the traced window."""

from .spans_util import total_ms


def read(ctx, name):
    if not ctx['steps']:
        return None
    ms = total_ms(ctx['spans'], ('service_tick',))
    return ms / ctx['steps'] if ms else None
