"""Gapped stage, the target's part of the device y-drop's set-up: the
program's spans "ydrop setup target" (the target's compact alphabet
and its codes' digest and upload; align/ydrop_device.py), those under
the tweener left out, seconds a query Mbp."""

from portbench.spans import stage_s_per_mbp


def read(r):
    return stage_s_per_mbp(r, "ydrop setup target")
