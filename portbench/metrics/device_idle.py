"""The device's idle share of the traced window: 1 - the union of its
operations' intervals (kernels, copies, sets) / the window's wall
time, from torch.profiler's trace."""


def read(ctx, name):
    s = ctx['summary']
    if not s or not ctx['window_s'] or not s['busy_us']:
        return None
    return 1.0 - s['busy_us'] / 1e6 / ctx['window_s']
