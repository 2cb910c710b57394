"""The LWW merge's share of its roofline: the least time the card could
take for what the timed batches' data needs, over the device time of
every kernel launched inside the timed steps (whatever it is named).

Bytes a batch needs (from the changes the harness handed in): each set
lane's key, op id and value (3 x 4 B) and its three flags (3 x 1 B),
read once; each distinct (doc, key) cell it writes, read and written
once in the winners and the values grids (2 x 2 x 4 B). Copies from the
host are not kernels and are not counted on either side."""

from ..bounds import roofline_pct

LANE_BYTES = 3 * 4 + 3
CELL_BYTES = 2 * 2 * 4


def read(ctx, name):
    counts = ctx['step_counts'][-ctx['steps']:] if ctx['steps'] else []
    if not counts or not ctx['summary']:
        return None
    n_bytes = sum(c['lanes'] * LANE_BYTES + c['cells'] * CELL_BYTES
                  for c in counts)
    return roofline_pct(n_bytes, ctx['summary']['step_kernel_us'])
