"""Seed search, the host's replay of the device's survivors: the
RunStats timer "hitgen report", seconds a query Mbp."""


def read(r):
    if not r["mbp"]:
        return None
    return sum(q.timers["hitgen report"] for q in r["records"]) / r["mbp"]
