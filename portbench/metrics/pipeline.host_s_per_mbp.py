"""Pipeline and output layer (pipeline.py, out/): the seconds a query
Mbp of per-query wall time outside the "seed search" and "gapped"
timers of the program's RunStats and the harness's tweener span."""


def read(r):
    if not r["mbp"]:
        return None
    rest = sum((q.done - q.handover) - q.timers["seed search"]
               - q.timers["gapped"] - q.tweener_s for q in r["records"])
    return rest / r["mbp"]
