"""Gapped stage, the accept loop's own time (align/ydrop.py): the
program's spans "gapped" less the spans "ydrop setup target" and
"ydrop device" under them and the host y-drop's time in them (the
bucket "ydrop host", timed once an anchor, kept in the spans' `inner`),
those under the tweener left out, seconds a query Mbp."""

from portbench.spans import under, window

PARTS = ("ydrop setup target", "ydrop device")


def read(r):
    spans = window(r)
    if spans is None or not r["mbp"]:
        return None
    total = 0.0
    for s in spans:
        if under(s, "tweener"):
            continue
        in_gapped = s.name == "gapped" or under(s, "gapped")
        if s.name == "gapped":
            total += s.t1 - s.t0
        elif s.name in PARTS and in_gapped:
            total -= s.t1 - s.t0
        if in_gapped and s.inner:
            total -= s.inner.get("ydrop host", 0.0)
    return total / r["mbp"]
