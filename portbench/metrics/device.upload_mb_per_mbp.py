"""Device: the megabytes the program's upload cache (device.py) copied
to the card on a miss, a query Mbp: the counter "upload bytes" over
the window's `query` spans."""

from portbench.spans import window


def read(r):
    spans = window(r)
    if spans is None or not r["mbp"]:
        return None
    total = sum((s.counts or {}).get("upload bytes", 0) for s in spans
                if s.name == "query")
    return total / 1e6 / r["mbp"]
