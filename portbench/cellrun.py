"""A run of one cell from start to result line (see run.py)."""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import guard
from .bench import ROOT, Cell, Run
from .faults import FAULTS
from .reference.scoring import Scores, read_matrix

FORBIDDEN = ("jax", "jaxlib", "flax", "lastz_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def reader(name: str):
    """The per-layer metric's reader, portbench/metrics/<name>.py."""
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_scores(cell):
    c = cell.config
    return Scores(read_matrix(os.path.join(cell.root, "portbench",
                                           "configs", c["scores_file"])),
                  c["reference"]["gap_open"], c["reference"]["gap_extend"])


def card_line(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t0: float, tmpdir: str, genome=None, traffic=None,
            log=sys.stderr):
    """Set-up, window and readings of one run: (run, result line's object
    without the check). A run that cannot be measured raises
    guard.Unmeasurable."""
    import torch
    run = Run(cell, seed, device, tmpdir, genome, traffic)
    run.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches = prof = None
    from .trace import Launches, device_intervals, device_reading
    with contextlib.ExitStack() as stack:
        if trace and cuda:
            launches = stack.enter_context(Launches().hooked())
            prof = stack.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]))
        host0 = time.monotonic()
        records = run.window(seconds)
    window_s = run.end - run.start
    mbp = sum(len(r.seq) for r in records) / 1e6
    walls = np.array([r.done - r.handover for r in records])
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    reading = {"records": records, "window_s": window_s, "mbp": mbp,
               "walls": walls, "launches": launches, "device": None}
    if prof is not None:
        reading["device"] = guard.traced(device_reading(
            device_intervals(prof), run.end - host0, host0, run.spans))
    log.write(f"card: {card_line(device)}\n")
    log.write(f"queries completed in the window: {len(records)}, "
              f"{mbp:.6f} Mbp in {window_s:.6f} s; per-query p50 "
              f"{np.percentile(walls, 50):.6f} s over {len(walls)} samples\n")
    e2e = {"align_mbp_per_s": mbp / window_s,
           "query_p95_s": float(np.percentile(walls, 95)),
           "setup_s": run.start - t0}
    metrics = {}
    if trace:
        for m in cell.metrics("per_layer"):
            v = reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {
        "correct": False,
        "attempted": len(run.records_all),
        "failed": len(run.records_all) - len(records),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak},
    }
    if reading["device"] is not None:
        d = reading["device"]
        result["device"]["busy_s"] = d["busy_s"]
        result["device"]["window_s"] = d["window_s"]
        result["breakdown"] = {"device_ops": d["device_ops"],
                               "idle_gaps": d["idle_gaps"]}
    # the check comes once the program's state is freed
    run.pt = run.target = None
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return run, result


def check(cell: Cell, run, records, fault=None):
    """The numbers of a window's outputs (after `fault`, one of
    faults.py's transforms for the configuration's judge, for the
    control and the tests) and the check's facts, by the judge the
    configuration names."""
    target = run.model.target
    if fault is not None:
        FAULTS[cell.check_name][fault](records, target,
                                       reference_scores(cell))
    queries = [{"name": r.name, "seq": r.seq, "text": r.text,
                "anchors": r.anchors} for r in records]
    return cell.judge().judge(
        queries, target, dict(cell.config["reference"]),
        reference_scores(cell), cell.limits["sample_queries"],
        np.random.default_rng([int(run.seed) % (1 << 64), 5]), run.device)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t0: float, tmpdir: str, genome=None, traffic=None, fault=None,
            log=sys.stderr):
    """A whole run: the result line's object, its check's numbers last."""
    run, result = measure(cell, seed, seconds, trace, device, t0, tmpdir,
                          genome, traffic, log)
    numbers, facts = check(cell, run, run.records, fault)
    # a cell compares the numbers its file gives a limit
    limits = cell.limits["limits"]
    result["correct"] = all(numbers[k] <= limits[k] for k in limits)
    log.write("check facts: " + json.dumps(facts) + "\n")
    for k in limits:
        log.write(f"check {k}: {numbers[k]!r} limit {limits[k]!r}\n")
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    return result


def main(argv, t0) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the default path of the program: no switch of its own is set
    for k in [k for k in os.environ if k.startswith("LASTZ_TORCH_")]:
        del os.environ[k]
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    cell = Cell(args.workload)
    if importlib.util.find_spec("lastz_tpu_torch") is None:
        sys.stderr.write("lastz_tpu_torch is not in this checkout\n")
        return 2
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"this cell needs {chips} CUDA device(s); torch "
                         f"finds {torch.cuda.device_count()}\n")
        return 3
    device = torch.device("cuda", 0)
    tmp_root = os.environ.get("TMPDIR") or None
    try:
        with tempfile.TemporaryDirectory(dir=tmp_root) as tmpdir:
            result = execute(cell, args.seed, args.seconds,
                             bool(args.trace), device, t0, tmpdir)
    except guard.Unmeasurable as failure:
        return guard.ended(failure, sys.stderr)
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"forbidden modules loaded: {found}\n")
        return 4
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0
