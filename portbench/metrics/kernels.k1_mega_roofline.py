"""Kernels: K1's mega launch (csrc/ydrop_chunk.cu via ops/ydrop_cuda.py)
as a share of its roofline, in %: the least time of the window's
launches (portbench/work.py) over their time between CUDA event pairs
around the C entry. Nothing to read without a launch."""


def read(r):
    k = r["launches"]
    got = k.roofline("ydrop_mega_launch") if k is not None else None
    return None if got is None else got["share"]
