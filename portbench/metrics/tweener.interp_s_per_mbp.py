"""Interpolation (align/tweener.py): the harness's span around
tweener_interpolate, seconds a query Mbp. The harness opens no span
inside it, so its self time is its whole time. Nothing to read in a
window whose queries never reached the tweener."""


def read(r):
    total = sum(q.tweener_s for q in r["records"])
    if not r["mbp"] or total == 0:
        return None
    return total / r["mbp"]
