"""Replicated growable arrays, as Automerge orders Text: an insert goes
right after its referent (or at the head), past every element already
there whose op id is greater than its own, since those were inserted
later after the same referent or descend from such; a delete hides its
target. Op ids compare by (counter, actor id)."""


def _op_key(op_id):
    ctr, actor = op_id.split('@', 1)
    return int(ctr), actor


def rga_text(ops, show_deleted=False):
    """The text after `ops`, a list of ('ins', op id, referent op id or
    None for the head, char) and ('del', target op id), in causal order.
    `show_deleted` keeps deleted characters (the control: deletes not
    applied)."""
    nxt = {None: None}            # element -> next element in order
    char, dead = {}, set()
    for op in ops:
        if op[0] == 'del':
            dead.add(op[1])
            continue
        _, op_id, ref, ch = op
        key = _op_key(op_id)
        prev, cur = ref, nxt[ref]
        while cur is not None and _op_key(cur) > key:
            prev, cur = cur, nxt[cur]
        nxt[prev], nxt[op_id] = op_id, cur
        char[op_id] = ch
    out, cur = [], nxt[None]
    while cur is not None:
        if show_deleted or cur not in dead:
            out.append(char[cur])
        cur = nxt[cur]
    return ''.join(out)
