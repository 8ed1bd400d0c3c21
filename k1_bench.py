#!/usr/bin/env python3
"""Time K1 (lastz_tpu_torch/csrc/ydrop_chunk.cu) beside other builds of
it on one NVIDIA card.

    python3 k1_bench.py --other NAME=SRC.cu [--other NAME=SRC.cu ...]

Each SRC.cu is another K1 source with the same C interface (for
example the parent commit's csrc/ydrop_chunk.cu), built with nvcc under
another symbol name into its own library.  Every build runs in turns
(others, package, package, others reversed) on the same inputs:

  cases    the first chunk of chip_smoke.py's K1_TIMED cases (the kernel
           table's "basic" shape and "wide_band", 128 lanes x 1536
           columns x 1024 rows), timed as chip_smoke.py times K1: CUDA
           events over its wrapper, the zeroed link buffer included;
           every build's state and link bytes must equal the package's
  main     the 4 Mbp default run of chip_smoke.py phase 3 with a CUDA
           event pair around every K1 launch; the builds' LAV must be
           equal

Prints one JSON object per line, with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def build_others(others, tdir):
    """{name: ctypes K1 entry} for each (name, source path), one nvcc
    process each, all at once; ptxas's report of each goes to stdout."""
    from lastz_tpu_torch.kernels import build
    nvcc = build._nvcc()
    procs = []
    for name, src in others:
        lib = os.path.join(tdir, f"lib{name}.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC, "-shared",
               f"-Dydrop_chunk_launch=ydrop_chunk_launch_{name}", "-o", lib,
               "-x", "cu", src]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns = {}
    for name, lib, p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-4000:]}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip(), flush=True)
        fn = getattr(ctypes.CDLL(lib), f"ydrop_chunk_launch_{name}")
        fn.argtypes = build._SIGNATURES["ydrop_chunk_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_cases(builds, order, card):
    """Each K1_TIMED case's first chunk, every build in turns."""
    import torch
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_chunk
    dev = torch.device("cuda")
    for case in cs.K1_CASES:
        name = case[0]
        if name not in cs.K1_TIMED:
            continue
        kw, state, sub_t, windows = cs.k1_setup(case, dev)
        args, _ = windows(state, np.zeros(cs.K1_SHAPE["B"], np.int64))
        ref_st, ref_tb = ydrop_chunk(*args, state, sub_t, **kw)
        n_bytes, cells = cs.k1_bytes(args, sub_t, state, ref_st)
        bound_ms, bound_by = cs.bound("ydrop_chunk", n_bytes, cells)
        for bname, fn in builds.items():
            with cs.timed_launches(fn=fn):
                st, tb = ydrop_chunk(*args, state, sub_t, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(tb, ref_tb) and all(
                    torch.equal(st[k], ref_st[k]) for k in st)):
                raise AssertionError(f"{bname} differs from the package's "
                                     f"K1 on {name}")
        times = {b: [] for b in builds}
        for bname in order:
            with cs.timed_launches(fn=builds[bname]):
                times[bname].append(cs.k1_ms(args, state, sub_t, kw))
        cs.say("k1_bench", case=name, cells=cells, bytes=n_bytes,
               bound_ms=bound_ms, bound_by=bound_by, order=order, ms=times,
               rows_used_mean=float(ref_st["rows_used"].float().mean()),
               card=card)


def time_main(builds, order, card):
    """K1's device ms per launch on chip_smoke.py's phase-3 run, once
    for each build in turns."""
    from lastz_tpu_torch import cli
    os.environ["LASTZ_TORCH_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tdir:
        tp, qp, _, _ = cs.write_pair(tdir, cs.make_pair())
        lav = {}
        for i, bname in enumerate(order):
            out = os.path.join(tdir, f"{i}.lav")
            t0 = time.monotonic()
            with open(out, "w") as f, contextlib.redirect_stdout(f), \
                    contextlib.redirect_stderr(io.StringIO()), \
                    cs.timed_launches(fn=builds[bname]) as events:
                rc = cli.main([tp, qp])
            ms = cs.launch_ms(events)
            wall_s = time.monotonic() - t0
            if rc != 0:
                raise RuntimeError(f"the port's CLI exited {rc}")
            with open(out, "rb") as f:
                lav[i] = f.read()
            cs.say("k1_bench", run="main", build=bname, **ms,
                   wall_s=wall_s, card=card)
    if len(set(lav.values())) != 1:
        raise AssertionError("the builds wrote different LAV")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", required=True,
                    help="NAME=SRC.cu: another K1 source to time beside it")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_bench: no CUDA device", file=sys.stderr)
        return 2
    from lastz_tpu_torch.kernels import build
    card = cs.card_line()
    print(card, flush=True)
    others = [tuple(spec.split("=", 1)) for spec in args.other]
    with tempfile.TemporaryDirectory() as tdir:
        t0 = time.monotonic()
        builds = build_others(others, tdir)
        builds["package"] = build.load().ydrop_chunk_launch
        cs.say("k1_bench", built=list(builds), build_s=time.monotonic() - t0)
        order = [n for n, _ in others] + ["package", "package"] + [
            n for n, _ in reversed(others)]
        time_cases(builds, order, card)
        time_main(builds, order, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
