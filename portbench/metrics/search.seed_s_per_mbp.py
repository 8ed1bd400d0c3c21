"""Seed search (search/engine.py -> search/device_hits.py ->
ops/hitgen.py): the RunStats timer "seed search", seconds a query
Mbp."""


def read(r):
    if not r["mbp"]:
        return None
    return sum(q.timers["seed search"] for q in r["records"]) / r["mbp"]
