#!/usr/bin/env python3
"""Time one of the main path's kernels beside other builds of it on one
NVIDIA card.

    python3 kernel_bench.py [--kernel ydrop_chunk|xdrop_scan|ydrop_traceback
                             |resolve_chains|ydrop_wavefront|ydrop_band]
                            --other NAME=SRC.cu [--other NAME=SRC.cu ...]
                            [--prefilled NAME] [--cut]
    python3 kernel_bench.py --kernel ydrop_mega [--other NAME=SRC.cu ...]
    python3 kernel_bench.py --kernel ydrop_mega --census [--out FILE.json]

--kernel (default ydrop_chunk, K1) names the kernel by its wrapper's
counter name in chip_smoke.py: K1, K2 (x-drop scan), the traceback
walk, the seed stage's chain walk, K3 or K3b.  Each SRC.cu is another
source of that kernel (for example the
parent commit's lastz_tpu_torch/csrc/<source>.cu), built with nvcc with
its C entry point renamed (-D<entry>=<entry>_<NAME>) into its own
library.  A source whose entry point takes fewer arguments than the
package's is called with the package's arguments in front of the
stream left out: that is how the first K2 (no queue, no counters)
runs.  Every build runs in turns (others, package, package, others
reversed) on the same inputs:

  cases    the kernel's shapes in chip_smoke.py, timed as chip_smoke.py
           times them (CUDA events over the wrapper, and the kernel
           alone: its C call replayed back to back, replay_ms, for all
           but K2, whose scratch counters must arrive zeroed): K1 the first
           chunk of each K1_TIMED case, K2 k2_setup's 2M hits, the walk
           walk_setup's mega launch, the chain walk the first launch of
           the 4 Mbp main path and of its --recoverseeds run, K3 and
           K3b K3_SHAPE in both orientations; every build's outputs must
           equal the package's
  main     the 4 Mbp default run of chip_smoke.py phase 3 (for the chain
           walk also with --recoverseeds) with a CUDA event pair around
           every launch of the kernel; the builds' LAV must be equal.
           K3 and K3b are off the CLI and have none, and so has K1's
           chunk entry since the main path runs K1 through its mega
           launch

--kernel ydrop_band --cut splits a K3b build's time between the rows
its early stop needs and the rest: each orientation also runs on its
input cut at ydrop_pallas.ydrop_band_rows (codes1 CUT, off the grid as
-1 is, from the rows the stop needs on), whose result must equal the
full input's, and each --other NAME=SRC.cu whose row loop loads its
code as `const int a = c1[row];` (K3b before its redesign, which has
no early stop) gets a second build, NAME_cut, whose row loop ends at
the first CUT row (a break after that load, in a copy of SRC: its
sweep cut to those rows).  Each K3b case prints the anchor rows of the grid and
of the stop, and each build's SM cycles a row under both counts (the
kernel alone's ms x 1.98 GHz x 132 SMs over the rows).

K2's cases include its wide instantiation (K2_WIDE's alphabets), which
only the package's build has: those cases time the package alone.

--kernel ydrop_mega times K1's mega launch against the loop it replaced
(chunk_loop: one K1 chunk launch per chunk, the host reading the lanes'
done flags before each, windows gathered by torch ops), or with --other
against other builds of the mega launch (a parent's
csrc/ydrop_chunk.cu), in turns (others, mega, mega, others): at
chip_smoke.py's MEGA_SHAPE, and per call on the 4 Mbp main path (an
event pair around each C call, kernel_ms, and around each call of
ydrop_device.ydrop_mega); outputs and LAV must be equal.

--kernel ydrop_mega --census captures the main path's mega calls and
runs each again through a build of csrc/ydrop_chunk.cu with
-DLASTZ_K1_PROFILE, whose mega launch records clock64 reads at each
row's phase boundaries and each row's band width.  It prints, per call,
each lane's chunks and rows and the longest lane's band census; over
all calls, the band census (tiles of 288 columns a row: p50, p90 and
max) and the row breakdown (cycles by phase, cycles a row by its
tiles, the least row latency).  The profile build's outputs must equal
the package's, and its row widths the plain version's
(ydrop_exact.lane_bands) on the call whose lane ran the most rows.
--out writes the per-call table as JSON.

A chain walk older than this package's (a parent's source) wrote only
the hits it walked into outputs its wrapper had filled; --prefilled
NAME fills them before each of that build's launches, inside its time.

Prints one JSON object per line, with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
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
    """K2 at k2_setup's shape, then its wide instantiation at each of
    K2_WIDE's alphabets (a case with its own C entry point)."""
    from lastz_tpu_torch.ops.xdrop_cuda import xdrop_scan
    out = []
    for name, args, entry in [("table", cs.k2_setup(dev), None)] + [
            (f"wide{K}", cs.k2_wide_setup(dev, K), "xdrop_scan_wide_launch")
            for K in cs.K2_WIDE]:
        def run(args=args):
            left, right = xdrop_scan(*args)
            return [*left, *right]

        out.append((name, run, 5, *cs.k2_bytes(args, xdrop_scan(*args)),
                    entry))
    return out


def walk_cases(dev):
    from lastz_tpu_torch.ops.ydrop_cuda import traceback_mega
    args = cs.walk_setup(dev)

    def run():
        return list(traceback_mega(*args))

    return [("table", run, 3, *cs.walk_bytes(args, traceback_mega(*args)))]


def chain_cases(dev):
    """The chain walk on the first launch of the 4 Mbp main path and of
    its --recoverseeds run, captured as chip_smoke.py captures them."""
    from lastz_tpu_torch import cli
    from lastz_tpu_torch.ops.resolve_cuda import resolve_chains
    os.environ["LASTZ_TORCH_DEVICE"] = "cuda"
    out = []
    with tempfile.TemporaryDirectory() as tdir:
        tp, qp, _, _ = cs.write_pair(tdir, cs.make_pair())
        for name, opts in (("main_launch", []),
                           ("recover_launch", ["--recoverseeds"])):
            with cs.chain_capture() as first, \
                    contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                if cli.main([tp, qp, *opts]) != 0:
                    raise RuntimeError(f"the port's CLI failed on {name}")
            a, kw = first[0]

            def run(a=a, kw=kw):
                return list(resolve_chains(*a, **kw))

            n_bytes, walked, _ = cs.chain_bytes(first[0])
            out.append((name, run, 5, n_bytes, walked))
    return out


def k3_cases(dev):
    """K3 at chip_smoke.K3_SHAPE, both orientations (it is off the CLI,
    so there is no main-path run)."""
    import torch
    from lastz_tpu_torch.ops.ydrop_pallas import (ydrop_extend_batch,
                                                  ydrop_wavefront_plain)
    geo = dict(band=cs.K3_SHAPE["band"], max_rows=cs.K3_SHAPE["max_rows"])
    out = []
    for rev, batch in cs.anchor_batches(cs.make_pair()).items():
        args = [torch.from_numpy(a).to(dev) for a in batch]

        def run(args=args):
            return [ydrop_extend_batch(*args, **geo)]

        _, span = ydrop_wavefront_plain(*args, **geo, live_span=True)
        out.append(("reversed" if rev else "forward", run, 3,
                    cs.nbytes(*args, run()[0]), int(span.sum())))
    return out


# codes1 past the stop rows in a K3b case's cut twin (--cut)
CUT = -2


def k3b_cases(dev, cut=False):
    """K3b at chip_smoke.K3_SHAPE, both orientations, and with cut each
    one's input cut at ydrop_band_rows (the kernel's result on it must
    equal the full input's).  Each case carries its anchor rows: the
    grid's and the stop's."""
    import torch
    from lastz_tpu_torch.ops import ydrop_pallas as tp
    geo = dict(band=cs.K3_SHAPE["band"], max_rows=cs.K3_SHAPE["max_rows"])
    out = []
    for rev, batch in cs.anchor_batches(cs.make_pair()).items():
        args = [torch.from_numpy(a).to(dev) for a in batch]
        _, span = tp.ydrop_band_plain(*args, **geo, live_span=True)
        rows = tp.ydrop_band_rows(*args, **geo)
        n_rows = dict(grid=args[0].shape[0] * geo["max_rows"],
                      stop=int(rows.sum()))
        case = "reversed" if rev else "forward"
        inputs = [(case, args)]
        if cut:
            inputs.append((case + "_cut",
                           [cs.cut_codes(args[0], rows, CUT), *args[1:]]))
        full = None
        for name, a in inputs:
            def run(a=a):
                return [tp.ydrop_band_batch(*a, **geo)]

            got = run()[0]
            full = got if full is None else full
            if not torch.equal(got, full):
                raise AssertionError(f"K3b on {name} differs from the "
                                     f"full input's result")
            out.append((name, run, 3, cs.nbytes(*a, got), int(span.sum()),
                        None, dict(rows=n_rows,
                                   swept_cells=n_rows["stop"] * geo["band"])))
    return out


def cut_variants(others, tdir):
    """[(NAME_cut, path)]: for each K3b source among others whose row
    loop loads its code as `const int a = c1[row];` (one without an early
    stop), a copy whose row loop ends at the first CUT row."""
    load = "const int a = c1[row];"
    out = []
    for name, src in others:
        with open(src) as f:
            text = f.read()
        if text.count(load) != 1:
            continue
        path = os.path.join(tdir, f"{name}_cut.cu")
        with open(path, "w") as f:
            f.write(text.replace(load, f"{load} if (a == {CUT}) break;"))
        out.append((f"{name}_cut", path))
    return out


# kernels whose C call cannot be replayed as it was made: K2's counters
# must arrive zeroed, and a replay would run its queue past its end
NO_REPLAY = {"xdrop_scan"}
# kernel: (C entry point, its cases, its runs on the CLI's path: the
# options of each, or None for a kernel off it)
KERNELS = {"ydrop_chunk": ("ydrop_chunk_launch", k1_cases, None),
           "xdrop_scan": ("xdrop_scan_launch", k2_cases, [[]]),
           "ydrop_traceback": ("ydrop_traceback_launch", walk_cases, [[]]),
           "resolve_chains": ("resolve_chains_launch", chain_cases,
                              [[], ["--recoverseeds"]]),
           "ydrop_wavefront": ("ydrop_wavefront_launch", k3_cases, None),
           "ydrop_band": ("ydrop_band_launch", k3b_cases, None)}


def prefilled(fn):
    """The chain walk's parent took alive and de_before filled with 1
    and 0 by its wrapper, and wrote only the hits it walked: this calls
    it after that fill (the fill's time counts in its time)."""
    import torch

    def view(ptr, n, typestr):
        class Raw:
            __cuda_array_interface__ = {"shape": (n,), "typestr": typestr,
                                        "data": (ptr, False), "version": 3,
                                        "strides": None}
        return torch.as_tensor(Raw(), device="cuda")

    def call(*a):
        H = a[9]
        view(a[12], H, "|u1").fill_(1)
        view(a[13], H, "<i4").fill_(0)
        return fn(*a)
    return call


def time_cases(kernel, builds, order, card, cut=False):
    """Each case of the kernel, every build in turns; a case with a C
    entry point of its own times the package's build alone."""
    import torch
    from lastz_tpu_torch.kernels import build
    own_entry, cases, _ = KERNELS[kernel]
    opts = dict(cut=True) if cut else {}
    all_builds, all_order = builds, order
    for name, run, reps, n_bytes, cells, *more in cases(
            torch.device("cuda"), **opts):
        case_entry = more[0] if more else None
        extra = more[1] if len(more) > 1 else {}
        entry = own_entry
        builds, order = all_builds, all_order
        if case_entry:
            entry = case_entry
            builds = {"package": getattr(build.load(), entry)}
            order = ["package", "package"]
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
        alone = {b: [] for b in builds}
        for bname in order:
            with cs.timed_launches(entry, fn=builds[bname]):
                times[bname].append(cs.cuda_ms(run, reps))
            if kernel not in NO_REPLAY:
                alone[bname].append(replay(entry, builds[bname], run))
        if "rows" in extra:
            extra["sm_cycles_per_row"] = {
                count: {b: [1e-3 * ms * cs.CLOCK_HZ * cs.SMS / n
                            for ms in v] for b, v in alone.items()}
                for count, n in extra["rows"].items()}
        cs.say("kernel_bench", kernel=kernel, case=name, cells=cells,
               bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
               order=order, ms=times, kernel_alone_ms=alone, **extra,
               card=card)


def replay(entry, fn, run):
    """chip_smoke.replay_ms of the build `fn`: its C call, captured from
    one run() through the package's wrapper, launched back to back."""
    from lastz_tpu_torch.kernels import build
    lib = build.load()
    own = getattr(lib, entry)
    setattr(lib, entry, fn)
    try:
        return cs.replay_ms(entry, run)
    finally:
        setattr(lib, entry, own)


def time_main(kernel, builds, order, card, opts=()):
    """The kernel's device ms per launch on chip_smoke.py's phase-3
    run (with `opts` added to its options), once for each build in
    turns."""
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
                rc = cli.main([tp, qp, *opts])
            ms = cs.launch_ms(events)
            wall_s = time.monotonic() - t0
            if rc != 0:
                raise RuntimeError(f"the port's CLI exited {rc}")
            with open(out, "rb") as f:
                lav[i] = f.read()
            cs.say("kernel_bench", kernel=kernel, run="main", options=opts,
                   build=bname, **ms, wall_s=wall_s, card=card)
    if len(set(lav.values())) != 1:
        raise AssertionError("the builds wrote different LAV")


def chunk_loop(v1c, v2c, a1, a2, low1, high1, low2, high2, rev, M, N,
               state, prev_off0, subsmall, *, gap_e, gap_oe, y_drop, lanes,
               rows, max_blocks, alpha, trim_to_peak, tb_cap, with_tb=True):
    """ydrop_mega as the gapped stage ran it before the mega launch: a
    host loop of K1 chunk launches, one read of any(~done) on the host
    and the window gather's torch ops before each, link bytes written in
    place into the block of tb_all."""
    import torch
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_chunk
    from lastz_tpu_torch.ops.ydrop_exact import gather_windows, pack_scalars
    i32 = torch.int32
    dev = v1c.device
    B = a1.shape[0]
    kw = dict(gap_e=gap_e, gap_oe=gap_oe, y_drop=y_drop, lanes=lanes,
              rows=rows, alpha=alpha, trim_to_peak=trim_to_peak,
              tb_cap=tb_cap)
    st = dict(state)
    prev_off = prev_off0.to(i32)
    nblk = torch.zeros(B, dtype=i32, device=dev)
    tb_all = torch.zeros((B, max_blocks, rows + 1, lanes) if with_tb
                         else (B, 1, 1, 1), dtype=torch.uint8, device=dev)
    row_lo = torch.zeros((B, max_blocks), dtype=i32, device=dev)
    row_hi = torch.zeros_like(row_lo)
    col0 = torch.zeros_like(row_lo)
    for k in range(max_blocks):
        active = ~st["done"]
        if not bool(active.any()):
            break
        row_base = st["row"] - 1
        b_off = torch.where(st["done"], prev_off, st["LY"])
        a_win, b_win = gather_windows(v1c, v2c, a1, a2, low1, high1, low2,
                                      high2, rev, row_base, b_off, rows,
                                      lanes)
        st, _ = ydrop_chunk(a_win, b_win, b_off, b_off - prev_off, M, N, st,
                            subsmall, tb_out=tb_all[:, k] if with_tb
                            else None, want_tb=with_tb, **kw)
        row_lo[:, k] = torch.where(active, row_base + 1, 0)
        row_hi[:, k] = torch.where(active, st["rows_used"], 0)
        col0[:, k] = torch.where(active, b_off, 0)
        nblk += active.to(i32)
        prev_off = b_off
    return st, prev_off, pack_scalars(st, nblk), tb_all, row_lo, row_hi, col0


def mega_bench(card, others=None):
    """--kernel ydrop_mega: the mega launch and chunk_loop in turns, at
    MEGA_SHAPE and per call on the 4 Mbp main path; with others, {name:
    C entry point} of other builds of the mega launch (build_others),
    each of those in chunk_loop's place.  On the main path each build's
    C calls have an event pair of their own (kernel_ms, as chip_smoke.py
    times main_path_ms), beside the pair around each wrapper call."""
    import torch
    from lastz_tpu_torch import cli
    from lastz_tpu_torch.align import ydrop_device
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_mega
    others = others or {}
    first = list(others) or ["chunk_loop"]
    impls = {n: ydrop_mega for n in others} if others else {
        "chunk_loop": chunk_loop}
    impls["mega"] = ydrop_mega
    order = first + ["mega", "mega"] + first[::-1]

    def entry(n):
        """The C entry point's event pairs while impl n runs."""
        if n == "chunk_loop":
            return cs.timed_launches("ydrop_chunk_launch")
        return cs.timed_launches("ydrop_mega_launch", fn=others.get(n))

    dev = torch.device("cuda")
    args, kw = cs.mega_setup(dev, cs.MEGA_SHAPE, 13)
    outs = {}
    for n in impls:
        with entry(n):
            outs[n] = impls[n](*args, **kw)
    for n in first:
        for a, b in zip(outs["mega"], outs[n]):
            for x, y in ([(a[k], b[k]) for k in a] if isinstance(a, dict)
                         else [(a, b)]):
                if not torch.equal(x, y):
                    raise AssertionError(f"the mega launch and {n} differ")
    n_bytes, cells = cs.mega_bytes(args, outs["mega"])
    bound_ms, bound_by = cs.bound("ydrop_mega", n_bytes, cells)
    ms = {n: [] for n in impls}
    wall = {n: [] for n in impls}
    for n in order:
        with entry(n):
            ms[n].append(cs.cuda_ms(lambda: impls[n](*args, **kw), 3))
            torch.cuda.synchronize()
            t0 = time.monotonic()
            impls[n](*args, **kw)
            torch.cuda.synchronize()
            wall[n].append(1000 * (time.monotonic() - t0))
    cs.say("kernel_bench", kernel="ydrop_mega", case="table",
           shape=cs.MEGA_SHAPE, chunks=int(outs["mega"][2][12].max()),
           cells=cells, bytes=n_bytes, bound_ms=bound_ms, bound_by=bound_by,
           order=order, ms=ms, host_ms=wall, card=card)
    os.environ["LASTZ_TORCH_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tdir:
        tp, qp, _, _ = cs.write_pair(tdir, cs.make_pair())
        lav = {}
        for i, n in enumerate(order):
            calls = []

            def timed(*a, n=n, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = impls[n](*a, **k)
                e1.record()
                calls.append((e0, e1, out[2][12].max()))
                return out

            own = ydrop_device.ydrop_mega
            ydrop_device.ydrop_mega = timed
            out = os.path.join(tdir, f"{i}.lav")
            t0 = time.monotonic()
            try:
                with open(out, "w") as f, contextlib.redirect_stdout(f), \
                        contextlib.redirect_stderr(io.StringIO()), \
                        entry(n) as events:
                    rc = cli.main([tp, qp])
            finally:
                ydrop_device.ydrop_mega = own
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t0
            if rc != 0:
                raise RuntimeError(f"the port's CLI exited {rc}")
            with open(out, "rb") as f:
                lav[i] = f.read()
            dms = np.array([a.elapsed_time(b) for a, b, _ in calls])
            cs.say("kernel_bench", kernel="ydrop_mega", run="main", impl=n,
                   calls=len(calls), chunks=sum(int(c) for *_, c in calls),
                   device_ms_per_call=float(dms.mean()),
                   device_ms_total=float(dms.sum()),
                   kernel_ms=cs.launch_ms(events), wall_s=wall_s, card=card)
    if len(set(lav.values())) != 1:
        raise AssertionError("the builds wrote different LAV")


# the row profile's phases (csrc/ydrop_chunk.cu, P_TILE .. P_PROL)
PHASES = ("tile", "scan", "store", "reductions", "tail", "prolongation")
PROFILE_ENTRY = "ydrop_mega_profile_launch"


def build_profile(tdir):
    """K1's source built with -DLASTZ_K1_PROFILE into a library of its
    own: the mega launch with its row profile (PROFILE_ENTRY, the
    production arguments, then the profile's buffers and room)."""
    from lastz_tpu_torch.kernels import build
    lib = os.path.join(tdir, "libk1profile.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared",
           "-DLASTZ_K1_PROFILE", "-o", lib,
           os.path.join(build.CSRC, "ydrop_chunk.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on the profile build:\n"
                           f"{(out.stdout + out.stderr)[-4000:]}")
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas profile:", line.strip(), flush=True)
    fn = getattr(ctypes.CDLL(lib), PROFILE_ENTRY)
    fn.argtypes = build._SIGNATURES["ydrop_mega_launch"] + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def profiled(fn):
    """Inside the block the mega wrapper launches the profile entry fn;
    yields a list that gets, for each launch, (phase cycles and rows
    (B, len(PHASES) + 1) int64, row widths and cycles (B, 2, cap)
    int32, its event pair)."""
    import torch
    from lastz_tpu_torch.kernels import build
    lib = build.load()
    own = lib.ydrop_mega_launch
    got = []

    def call(*a):
        B, cap = a[24], a[19] * a[26]
        ph = torch.zeros((B, len(PHASES) + 1), dtype=torch.int64,
                         device="cuda")
        rows = torch.zeros((B, 2, cap), dtype=torch.int32, device="cuda")
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        rc = fn(*a, ph.data_ptr(), rows.data_ptr(), cap)
        e1.record()
        got.append((ph, rows, e0, e1))
        return rc

    lib.ydrop_mega_launch = call
    try:
        yield got
    finally:
        lib.ydrop_mega_launch = own


def pct(x, q):
    return float(np.percentile(x, q)) if len(x) else None


def census_bench(card, out_path=None):
    """--census: the main path's mega calls, captured, each run again
    through the profile build: the band census (tiles of 288 a row over
    all rows and each call's longest lane), each lane's chunks and rows
    a call, and the clock64 breakdown of a row; the profile build's
    outputs and its row widths must equal the package's and the plain
    version's (on the call whose lane ran the most rows)."""
    import torch
    from lastz_tpu_torch import cli
    from lastz_tpu_torch.ops import ydrop_exact as tx
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_mega
    os.environ["LASTZ_TORCH_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tdir:
        fn = build_profile(tdir)
        tp, qp, _, _ = cs.write_pair(tdir, cs.make_pair())
        with open(os.path.join(tdir, "out.lav"), "w") as f, \
                contextlib.redirect_stdout(f), \
                contextlib.redirect_stderr(io.StringIO()), \
                cs.timed_launches("ydrop_mega_launch") as events, \
                cs.mega_capture() as calls:
            if cli.main([tp, qp]) != 0:
                raise RuntimeError("the port's CLI failed")
        ms = cs.launch_ms(events)
    launch_ms = [a.elapsed_time(b) for a, b in events]
    widths, per_call, phase, row_cyc, row_til = [], [], 0, [], []
    longest = (0, -1)
    for i, (args, kw, want) in enumerate(calls):
        with profiled(fn) as prof:
            got = ydrop_mega(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(got[0][k], want[0][k]) for k in want[0]) or \
                not all(torch.equal(a, b) for a, b in
                        zip((*got[1:3], *got[4:]), want[1:])):
            raise AssertionError(f"call {i}: the profile build differs")
        ph, rows, e0, e1 = prof[0]
        ph, rows = ph.cpu().numpy(), rows.cpu().numpy()
        nblk = want[2][12].cpu().numpy()
        n_rows = tx.lane_rows(nblk, want[3].cpu().numpy(),
                              want[4].cpu().numpy())
        if not np.array_equal(ph[:, -1], n_rows):
            raise AssertionError(f"call {i}: profiled rows differ from the "
                                 f"outputs' rows")
        w = [rows[b, 0, :n].astype(np.int64) for b, n in enumerate(n_rows)]
        widths.extend(w)
        phase = phase + ph[:, :-1].sum(0)
        for b, n in enumerate(n_rows):
            row_cyc.append(rows[b, 1, :n])
            row_til.append(tx.row_tiles(w[b]))
        c = tx.band_census(w)
        lane = c["longest_lane"]["lane"]
        cyc_long = int(rows[lane, 1, :n_rows[lane]].sum())
        prof_ms = e0.elapsed_time(e1)
        if n_rows.max() > longest[0]:
            longest = (int(n_rows.max()), i)
        per_call.append(dict(
            call=i, lanes=len(nblk), with_tb=bool(kw.get("with_tb", True)),
            chunks_max=int(nblk.max()),
            lanes_by_chunks={int(k): int((nblk == k).sum())
                             for k in np.unique(nblk)},
            rows_max=int(n_rows.max()), rows_p50=pct(n_rows, 50),
            rows_p90=pct(n_rows, 90), rows_sum=int(n_rows.sum()),
            lane_rows_share=float(n_rows.sum()
                                  / max(len(n_rows) * n_rows.max(), 1)),
            rows_after_median_share=float(
                (n_rows.max() - pct(n_rows, 50)) / max(n_rows.max(), 1)),
            device_ms=launch_ms[i],
            ns_per_row_of_longest_lane=1e6 * launch_ms[i]
            / max(int(n_rows.max()), 1),
            longest_lane=c["longest_lane"], profile_ms=prof_ms,
            profile_cycles_of_longest_lane=cyc_long,
            profile_mhz=cyc_long / max(prof_ms, 1e-9) / 1e3))
        cs.say("census", **per_call[-1], card=card)
    # the plain version's widths on the call with the most rows a lane
    args, kw, _ = calls[longest[1]]
    bands = []
    tx.ydrop_mega_plain(*args, bands=bands, **kw)
    first = sum(len(c[2][0]["done"]) for c in calls[:longest[1]])
    plain_w = tx.lane_bands(bands)
    own_w = widths[first: first + len(plain_w)]
    if len(plain_w) != len(own_w) or not all(
            np.array_equal(a, b) for a, b in zip(plain_w, own_w)):
        raise AssertionError("the profile's row widths differ from the "
                             "plain version's")
    census = tx.band_census(widths)
    cyc = np.concatenate(row_cyc)
    til = np.concatenate(row_til)
    by_tiles = {int(t): dict(rows=int((til == t).sum()),
                             mean=float(cyc[til == t].mean()),
                             min=int(cyc[til == t].min()),
                             p10=pct(cyc[til == t], 10))
                for t in np.unique(til)}
    total = float(phase.sum())
    cs.say("census", calls=len(calls), device_ms=ms,
           rows_checked_against_plain=int(sum(len(w) for w in plain_w)),
           band_census=census["all"], card=card)
    cs.say("census", breakdown_cycles={
        p: int(v) for p, v in zip(PHASES, phase)},
        breakdown_share={p: float(v / total) for p, v in zip(PHASES, phase)},
        rows=int(len(cyc)), cycles_per_row_mean=float(cyc.mean()),
        cycles_per_row_by_tiles=by_tiles,
        least_row_cycles=int(cyc.min()), card=card)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(dict(card=card, calls=per_call, census=census,
                           by_tiles=by_tiles,
                           breakdown=dict(zip(PHASES, map(int, phase)))), f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=list(KERNELS) + ["ydrop_mega"],
                    default="ydrop_chunk",
                    help="the kernel to time (default K1, ydrop_chunk)")
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=SRC.cu: another source of the kernel")
    ap.add_argument("--census", action="store_true",
                    help="with --kernel ydrop_mega: the band census, each "
                    "lane's rows and the row breakdown of the main path's "
                    "mega calls (profile build)")
    ap.add_argument("--out", help="with --census: a JSON file for the "
                    "census's per-call table")
    ap.add_argument("--cut", action="store_true",
                    help="with --kernel ydrop_band: also the inputs cut at "
                    "the stop rows, and a NAME_cut build of each --other "
                    "that ends its sweep there")
    ap.add_argument("--prefilled", action="append", default=[],
                    help="NAME of an --other chain walk that needs its "
                    "outputs filled first (a source whose wrapper filled "
                    "alive and de_before)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    from lastz_tpu_torch.kernels import build
    card = cs.card_line()
    print(card, flush=True)
    if args.kernel == "ydrop_mega":
        if args.census:
            census_bench(card, args.out)
            return 0
        with tempfile.TemporaryDirectory() as tdir:
            mega_bench(card, build_others(
                "ydrop_mega_launch",
                [tuple(spec.split("=", 1)) for spec in args.other], tdir))
        return 0
    if not args.other:
        ap.error("--other is required")
    if args.cut and args.kernel != "ydrop_band":
        ap.error("--cut needs --kernel ydrop_band")
    entry, _, main_runs = KERNELS[args.kernel]
    others = [tuple(spec.split("=", 1)) for spec in args.other]
    with tempfile.TemporaryDirectory() as tdir:
        t0 = time.monotonic()
        if args.cut:
            others += cut_variants(others, tdir)
        builds = build_others(entry, others, tdir)
        for name in args.prefilled:
            builds[name] = prefilled(builds[name])
        builds["package"] = getattr(build.load(), entry)
        cs.say("kernel_bench", kernel=args.kernel, built=list(builds),
               build_s=time.monotonic() - t0)
        order = [n for n, _ in others] + ["package", "package"] + [
            n for n, _ in reversed(others)]
        time_cases(args.kernel, builds, order, card, args.cut)
        for opts in main_runs or ():
            time_main(args.kernel, builds, order, card, opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
