"""The interpreter's collector's share of the traced window: the seconds
its pauses took (timed by `gc.callbacks`) over the window's wall
time."""


def read(ctx, name):
    if not ctx['window_s']:
        return None
    return ctx['gc_s'] / ctx['window_s']
