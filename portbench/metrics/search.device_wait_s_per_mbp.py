"""Seed search, the host blocked on the card: the program's spans
"hitgen wait" (every blocking fetch of the device search), those under
the tweener left out, seconds a query Mbp."""

from portbench.spans import stage_s_per_mbp


def read(r):
    return stage_s_per_mbp(r, "hitgen wait")
