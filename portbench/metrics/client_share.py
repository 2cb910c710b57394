"""The load generator's share of the traced window: the harness's own
clock over the time it spent minting payloads and running the sync
clients' host protocol (which shares the service's process and cores)."""


def read(ctx, name):
    if ctx.get('client_s') is None or not ctx['window_s']:
        return None
    return ctx['client_s'] / ctx['window_s']
