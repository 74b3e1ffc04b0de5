"""Host ms a step inside the multi-sequence tracker's own ``consume`` stage
(its StageTimer): the B sequences' slices of the batched outputs consumed
on the tracker's thread pool (keyframe events, map maintenance, loop
closing's hand-offs), over the window's batched steps."""


def read(run):
    rows = run.spans.get("consume")
    if not rows or sum(n for _, n in rows) == 0:
        return None
    return 1e3 * sum(s for s, _ in rows) / sum(n for _, n in rows)
