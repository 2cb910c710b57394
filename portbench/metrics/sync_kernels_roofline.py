"""The sync round's device kernels' share of their roofline: the least
time the card could take for what the rounds' data needs, over the
device time of every kernel launched inside the timed rounds (whatever
it is named: the Bloom and frontier-index kernels and any other).

Bytes a round needs (from the messages the harness handed in), each
read or written once: every peer's message bytes (its filter among
them); 12 B of every candidate change hash probed against the peer's
filter (the bytes the probes hash); 12 B of every hash the hub's own
filter takes, and that filter's bytes (12 B of header and 10 bits an
entry) written. Copies from the host are not kernels and are not counted
on either side."""

from ..bounds import roofline_pct


def read(ctx, name):
    counts = ctx['step_counts'][-ctx['steps']:] if ctx['steps'] else []
    if not counts or not ctx['summary']:
        return None
    n_bytes = 0
    for c in counts:
        per_link = c['sent_hashes'] // c['links']
        n_bytes += (c['filter_bytes'] + 12 * c['candidates'] +
                    12 * c['sent_hashes'] +
                    c['links'] * (12 + (per_link * 10 + 7) // 8))
    return roofline_pct(n_bytes, ctx['summary']['step_kernel_us'])
