"""Gapped stage, the host blocked on the card: the program's spans
"ydrop wait" (each fetch of a mega launch's packed scalars, of its
continuations' and of the traceback walk's outputs), those under the
tweener left out, seconds a query Mbp."""

from portbench.spans import stage_s_per_mbp


def read(r):
    return stage_s_per_mbp(r, "ydrop wait")
