"""The control of the concurrent Text cell: RGA with one guarantee
broken. Concurrent inserts at one referent stay in the order they
arrived, not in op-id order: an insert goes right after its referent,
past every element whose counter is at least its own, so of two inserts
with the same counter the later arrival lands after the earlier one
whatever their actors. Deletes hide their target, as in
`text_rga.rga_text`."""

from .text_rga import _op_key


def rga_text_arrival(ops):
    """The text after `ops` (as `text_rga.rga_text` takes them), with
    ties at a referent in arrival order."""
    nxt = {None: None}
    char, dead = {}, set()
    for op in ops:
        if op[0] == 'del':
            dead.add(op[1])
            continue
        _, op_id, ref, ch = op
        ctr = _op_key(op_id)[0]
        prev, cur = ref, nxt[ref]
        while cur is not None and _op_key(cur)[0] >= ctr:
            prev, cur = cur, nxt[cur]
        nxt[prev], nxt[op_id] = op_id, cur
        char[op_id] = ch
    out, cur = [], nxt[None]
    while cur is not None:
        if cur not in dead:
            out.append(char[cur])
        cur = nxt[cur]
    return ''.join(out)
