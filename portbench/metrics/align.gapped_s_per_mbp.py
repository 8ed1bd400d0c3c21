"""Gapped stage (align/ydrop.py, align/ydrop_device.py): the RunStats
timer "gapped", seconds a query Mbp."""


def read(r):
    if not r["mbp"]:
        return None
    return sum(q.timers["gapped"] for q in r["records"]) / r["mbp"]
