"""Seed search, the target's part of the device search's set-up: the
program's spans "hitgen setup target" (the target's compact alphabet,
the digest and upload of its codes, the position table's upload or
lookup; device.carry_state), those under the tweener left out,
seconds a query Mbp."""

from portbench.spans import stage_s_per_mbp


def read(r):
    return stage_s_per_mbp(r, "hitgen setup target")
