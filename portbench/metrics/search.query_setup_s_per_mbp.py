"""Seed search, the query's part of the device search's set-up: the
program's spans "hitgen setup query" (the query's codes and their
upload, its packed seed words and padding; search/device_hits.py),
those under the tweener left out, seconds a query Mbp."""

from portbench.spans import stage_s_per_mbp


def read(r):
    return stage_s_per_mbp(r, "hitgen setup query")
