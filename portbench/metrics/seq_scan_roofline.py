"""The RGA sequence scan's share of its roofline: the least time the
card could take for what the timed batches' data needs, over the device
time of every kernel launched inside the timed steps (whatever it is
named).

Bytes a batch needs (from the ops the harness handed in), each read or
written once: an insert reads its kind (1 B), referent, op id and
character (3 x 4 B) and writes the new element's id, link and character
and its referent's link (4 x 4 B); a delete reads its kind, target and
op id (1 + 2 x 4 B) and writes the target's visibility (4 B). Nothing
is counted for finding a referent in its row. Copies from the host are
not kernels and are not counted on either side."""

from ..bounds import roofline_pct

INSERT_BYTES = 1 + 3 * 4 + 4 * 4
DELETE_BYTES = 1 + 2 * 4 + 4


def read(ctx, name):
    counts = ctx['step_counts'][-ctx['steps']:] if ctx['steps'] else []
    if not counts or not ctx['summary']:
        return None
    n_bytes = sum(c['inserts'] * INSERT_BYTES + c['deletes'] * DELETE_BYTES
                  for c in counts)
    return roofline_pct(n_bytes, ctx['summary']['step_kernel_us'])
