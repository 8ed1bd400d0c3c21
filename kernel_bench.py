#!/usr/bin/env python3
"""Time one of the main path's kernels beside other builds of it on one
NVIDIA card.

    python3 kernel_bench.py [--kernel ydrop_chunk|xdrop_scan|ydrop_traceback]
                            --other NAME=SRC.cu [--other NAME=SRC.cu ...]

--kernel (default ydrop_chunk, K1) names the kernel by its wrapper's
counter name in chip_smoke.py: K1, K2 (x-drop scan) or the traceback
walk.  Each SRC.cu is another source of that kernel (for example the
parent commit's lastz_tpu_torch/csrc/<source>.cu), built with nvcc with
its C entry point renamed (-D<entry>=<entry>_<NAME>) into its own
library.  A source whose entry point takes fewer arguments than the
package's is called with the package's arguments in front of the
stream left out: that is how the first K2 (no queue, no counters)
runs.  Every build runs in turns (others, package, package, others
reversed) on the same inputs:

  cases    the kernel's shapes in chip_smoke.py, timed as chip_smoke.py
           times them (CUDA events over the wrapper): K1 the first
           chunk of each K1_TIMED case, K2 k2_setup's 2M hits, the walk
           walk_setup's mega launch; every build's outputs must equal
           the package's
  main     the 4 Mbp default run of chip_smoke.py phase 3 with a CUDA
           event pair around every launch of the kernel; the builds'
           LAV must be equal

Prints one JSON object per line, with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def n_params(src, entry) -> int:
    """The number of parameters of the C entry point `entry` in src."""
    with open(src) as f:
        m = re.search(r'extern "C" int\s+' + entry + r"\s*\(([^)]*)\)",
                      f.read())
    if m is None:
        raise ValueError(f"{src} defines no {entry}")
    return m.group(1).count(",") + 1


def build_others(entry, others, tdir):
    """{name: callable with the package's C signature} for each (name,
    source path), one nvcc process each, all at once; ptxas's report of
    each goes to stdout."""
    from lastz_tpu_torch.kernels import build
    nvcc = build._nvcc()
    procs = []
    for name, src in others:
        lib = os.path.join(tdir, f"lib{name}.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC, "-shared",
               f"-D{entry}={entry}_{name}", "-o", lib, "-x", "cu", src]
        procs.append((name, src, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    sig = build._SIGNATURES[entry]
    fns = {}
    for name, src, lib, p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-4000:]}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip(), flush=True)
        fn = getattr(ctypes.CDLL(lib), f"{entry}_{name}")
        k = n_params(src, entry)
        fn.argtypes = sig[:k - 1] + sig[-1:]
        fn.restype = ctypes.c_int
        fns[name] = fn if k == len(sig) else (
            lambda *a, fn=fn, k=k: fn(*a[:k - 1], a[-1]))
    return fns


def k1_cases(dev):
    """(case name, run, reps, bytes, cells) of K1's K1_TIMED cases; run()
    returns every output tensor of the package's wrapper."""
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_chunk
    out = []
    for case in cs.K1_CASES:
        if case[0] not in cs.K1_TIMED:
            continue
        kw, state, sub_t, windows = cs.k1_setup(case, dev)
        args, _ = windows(state, np.zeros(cs.K1_SHAPE["B"], np.int64))

        def run(args=args, state=state, sub_t=sub_t, kw=kw):
            st, tb = ydrop_chunk(*args, state, sub_t, **kw)
            return [tb, *st.values()]

        st, _ = ydrop_chunk(*args, state, sub_t, **kw)
        out.append((case[0], run, 5, *cs.k1_bytes(args, sub_t, state, st)))
    return out


def k2_cases(dev):
    from lastz_tpu_torch.ops.xdrop_cuda import xdrop_scan
    args = cs.k2_setup(dev)

    def run():
        left, right = xdrop_scan(*args)
        return [*left, *right]

    return [("table", run, 5, *cs.k2_bytes(args, xdrop_scan(*args)))]


def walk_cases(dev):
    from lastz_tpu_torch.ops.ydrop_cuda import traceback_mega
    args = cs.walk_setup(dev)

    def run():
        return list(traceback_mega(*args))

    return [("table", run, 3, *cs.walk_bytes(args, traceback_mega(*args)))]


# kernel: (C entry point, its cases)
KERNELS = {"ydrop_chunk": ("ydrop_chunk_launch", k1_cases),
           "xdrop_scan": ("xdrop_scan_launch", k2_cases),
           "ydrop_traceback": ("ydrop_traceback_launch", walk_cases)}


def time_cases(kernel, builds, order, card):
    """Each case of the kernel, every build in turns."""
    import torch
    entry, cases = KERNELS[kernel]
    for name, run, reps, n_bytes, cells in cases(torch.device("cuda")):
        bound_ms, bound_by = cs.bound(kernel, n_bytes, cells)
        ref = run()
        for bname, fn in builds.items():
            with cs.timed_launches(entry, fn=fn):
                got = run()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{bname} differs from the package's "
                                     f"{kernel} on {name}")
        times = {b: [] for b in builds}
        for bname in order:
            with cs.timed_launches(entry, fn=builds[bname]):
                times[bname].append(cs.cuda_ms(run, reps))
        cs.say("kernel_bench", kernel=kernel, case=name, cells=cells,
               bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
               order=order, ms=times, card=card)


def time_main(kernel, builds, order, card):
    """The kernel's device ms per launch on chip_smoke.py's phase-3
    run, once for each build in turns."""
    from lastz_tpu_torch import cli
    entry = KERNELS[kernel][0]
    os.environ["LASTZ_TORCH_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tdir:
        tp, qp, _, _ = cs.write_pair(tdir, cs.make_pair())
        lav = {}
        for i, bname in enumerate(order):
            out = os.path.join(tdir, f"{i}.lav")
            t0 = time.monotonic()
            with open(out, "w") as f, contextlib.redirect_stdout(f), \
                    contextlib.redirect_stderr(io.StringIO()), \
                    cs.timed_launches(entry, fn=builds[bname]) as events:
                rc = cli.main([tp, qp])
            ms = cs.launch_ms(events)
            wall_s = time.monotonic() - t0
            if rc != 0:
                raise RuntimeError(f"the port's CLI exited {rc}")
            with open(out, "rb") as f:
                lav[i] = f.read()
            cs.say("kernel_bench", kernel=kernel, run="main", build=bname,
                   **ms, wall_s=wall_s, card=card)
    if len(set(lav.values())) != 1:
        raise AssertionError("the builds wrote different LAV")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=list(KERNELS), default="ydrop_chunk",
                    help="the kernel to time (default K1, ydrop_chunk)")
    ap.add_argument("--other", action="append", required=True,
                    help="NAME=SRC.cu: another source of the kernel")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    from lastz_tpu_torch.kernels import build
    card = cs.card_line()
    print(card, flush=True)
    entry = KERNELS[args.kernel][0]
    others = [tuple(spec.split("=", 1)) for spec in args.other]
    with tempfile.TemporaryDirectory() as tdir:
        t0 = time.monotonic()
        builds = build_others(entry, others, tdir)
        builds["package"] = getattr(build.load(), entry)
        cs.say("kernel_bench", kernel=args.kernel, built=list(builds),
               build_s=time.monotonic() - t0)
        order = [n for n, _ in others] + ["package", "package"] + [
            n for n, _ in reversed(others)]
        time_cases(args.kernel, builds, order, card)
        time_main(args.kernel, builds, order, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
