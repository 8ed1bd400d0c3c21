"""Gapped stage: the share of gapped extensions run on the card,
RunStats gapped_device over gapped_device + gapped_host, in %. Nothing
to read in a window without gapped extensions."""


def read(r):
    dev = sum(q.counts["gapped_device"] for q in r["records"])
    host = sum(q.counts["gapped_host"] for q in r["records"])
    if dev + host == 0:
        return None
    return 100.0 * dev / (dev + host)
