"""The port's query farm-out (lastz_tpu_torch/parallel/farm.py) and its
distributed runs (parallel/distributed.py) on the CPU, against
lastz_tpu: the farm over FARM_SLOTS of CPU slots writes output
byte-equal to the port's serial run, to lastz_tpu's host Pipeline and
to lastz_tpu's farm on the suite's 8-device CPU mesh; the gates agree
with lastz_tpu's; two gloo processes give rank 0 the serial output and
census; and the locks the farm's threads rely on hold."""

import contextlib
import dataclasses
import io
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import lastz_tpu.align.ydrop_device as jydd
import lastz_tpu.core.scoring as jscoring
import lastz_tpu.parallel.distributed as jdist
import lastz_tpu.parallel.farm as jfarm
import lastz_tpu_torch.align.ydrop_device as tydd
import lastz_tpu_torch.core.scoring as tscoring
import lastz_tpu_torch.parallel.distributed as tdist
import lastz_tpu_torch.parallel.farm as tfarm
import lastz_tpu_torch.pipeline as tpipe
from lastz_tpu.cli import parse_options as jparse
from lastz_tpu.pipeline import Pipeline as JPipeline
from lastz_tpu.stats import RunStats as JRunStats
from lastz_tpu_torch import cli, native
from lastz_tpu_torch.cli import parse_options as tparse
from lastz_tpu_torch.kernels import build
from lastz_tpu_torch.stats import RunStats as TRunStats

from test_farm_multichip import _make_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QSCORES = os.path.join(REPO, "tests", "golden", "quantum", "qscores.txt")
# lastz_tpu's farm as tests/test_farm_multichip.py runs it
JAX_FARM_ENV = {"LASTZ_TPU_DEVICE": "1", "LASTZ_TPU_FARM": "1",
                "LASTZ_TPU_HIT_BUDGET": str(1 << 14),
                "LASTZ_TPU_YDROP_WIDTH": "192",
                "LASTZ_TPU_YDROP_ROWS": "128",
                "LASTZ_TPU_YDROP_BATCH": "8"}


@pytest.fixture
def port_cpu(monkeypatch):
    """The port on the CPU at a tiny y-drop geometry, no farm slots."""
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    for k in ("LASTZ_TORCH_FARM", "LASTZ_TORCH_DIST",
              "LASTZ_TORCH_FARM_TEST_DELAY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tydd, "DEFAULT_WIDTH", 192)
    monkeypatch.setattr(tydd, "DEFAULT_ROWS", 128)
    monkeypatch.setattr(tydd, "DEFAULT_BATCH", 8)
    monkeypatch.setattr(tpipe, "FARM_SLOTS", None)
    return monkeypatch


@contextlib.contextmanager
def env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def port_run(args, slots=None, monkeypatch=None):
    """The port's Pipeline on args, over FARM_SLOTS `slots` (None: no
    farm); returns (output, pipeline)."""
    if monkeypatch is not None:
        monkeypatch.setattr(tpipe, "FARM_SLOTS", slots)
    buf = io.StringIO()
    pl = tpipe.Pipeline(tparse(args), buf)
    pl.run()
    return buf.getvalue(), pl


def jax_run(args, **kw):
    """lastz_tpu's Pipeline on args with the LASTZ_TPU_* switches kw
    (none: its host path); returns (output, pipeline)."""
    drop = [k for k in os.environ if k.startswith("LASTZ_TPU_")]
    saved = {k: os.environ.pop(k) for k in drop}
    geo = (jydd.DEFAULT_WIDTH, jydd.DEFAULT_ROWS, jydd.DEFAULT_BATCH)
    jydd.DEFAULT_WIDTH, jydd.DEFAULT_ROWS, jydd.DEFAULT_BATCH = 192, 128, 8
    try:
        with env(**kw):
            buf = io.StringIO()
            pl = JPipeline(jparse(args), buf)
            pl.run()
            return buf.getvalue(), pl
    finally:
        jydd.DEFAULT_WIDTH, jydd.DEFAULT_ROWS, jydd.DEFAULT_BATCH = geo
        os.environ.update(saved)


@pytest.fixture(scope="module")
def farm_inputs(tmp_path_factory):
    """tests/test_farm_multichip.py's six queries against one target,
    and by format the port's serial run and lastz_tpu's host and farm
    outputs on them (each made once: the 8-device farm compiles for
    every device)."""
    t, q = _make_inputs(tmp_path_factory.mktemp("farm"))
    want = {}

    def reference(fmt):
        """(port serial output, its pipeline, lastz_tpu host output,
        lastz_tpu farm output); called under port_cpu."""
        if fmt not in want:
            args = [t, q, f"--format={fmt}", "--ydrop=3000"]
            serial, spl = port_run(args)
            assert not getattr(spl, "_farmed", False)
            host, _ = jax_run(args)
            farmed, jpl = jax_run(args, **JAX_FARM_ENV)
            assert getattr(jpl, "_farmed", False)
            want[fmt] = serial, spl, host, farmed
        return want[fmt]
    return t, q, reference


@pytest.mark.parametrize("fmt", ["lav", "maf"])
@pytest.mark.parametrize("slots", [2, 3])
def test_farm_matches_serial_host_and_lastz_tpu_farm(port_cpu, farm_inputs,
                                                     fmt, slots):
    t, q, reference = farm_inputs
    args = [t, q, f"--format={fmt}", "--ydrop=3000"]
    serial, spl, host, jax_farmed = reference(fmt)
    farmed, fpl = port_run(args, ["cpu"] * slots, port_cpu)
    assert fpl._farmed, "the farm did not run"
    assert [str(d) for d in fpl._farm_devices()] == ["cpu"] * slots
    assert farmed == serial
    assert farmed == host
    assert farmed == jax_farmed
    assert farmed.count("a {" if fmt == "lav" else "\na ") >= 6
    # the workers' collectors were merged into the parent's
    assert fpl.stats.alignments == spl.stats.alignments > 0
    assert fpl.stats.gapped_device == spl.stats.gapped_device > 0


def test_farm_of_twins_and_a_quantum_query(port_cpu, tmp_path):
    """The batched search (--twins, quantum DNA) under the farm: the
    same output as the serial run and as lastz_tpu's host path."""
    from test_torch_isolation import multi_query_pair
    t, q = multi_query_pair(tmp_path)
    for args in ([t, q, "--ydrop=3000", "--twins=20..200"],
                 [t, q, f"Q={QSCORES}"]):
        if args[-1].startswith("Q="):
            seq = [ln for ln in open(q).read().split("\n")
                   if ln and not ln.startswith(">")]
            qdna = tmp_path / "q.qdna"
            with open(qdna, "wb") as f:
                subprocess.run(
                    [sys.executable, "-m", "lastz_tpu.tools.any_to_qdna",
                     "--striplinebreaks"],
                    input=bytes(b"ACGT".index(c) + 1
                                for c in "".join(seq[:2]).encode()),
                    stdout=f, check=True, cwd=REPO)
            args[1] = f"{qdna}[quantum]"
        serial, _ = port_run(args)
        farmed, fpl = port_run(args, ["cpu", "cpu"], port_cpu)
        port_cpu.setattr(tpipe, "FARM_SLOTS", None)
        assert fpl._farmed
        assert farmed == serial == jax_run(args)[0]
        assert "a {" in farmed


def _gated_options(tmp_path):
    return {
        "default": [],
        "census": ["--census"],
        "dynamic_masking": ["--masking=3"],
        "shard": ["--shard=0/2"],
        "search_limit": ["--queryhsplimit=5"],
        "masking_file": [f"--outputmasking:soft={tmp_path}/soft.txt"],
        "inferonly": ["--inferonly", "--scoretype=double"],
        "format": ["--format=identity"],
        "side_file": [f"--maf={tmp_path}/side.maf"],
    }


@pytest.mark.parametrize("config", list(_gated_options("")))
def test_gates_agree_with_lastz_tpu(port_cpu, tmp_path, config):
    """farm_supported and dist_supported give lastz_tpu's answers on
    the configurations they exclude (and on the default run)."""
    t, q = _make_inputs(tmp_path, nq=2)
    args = [t, q, *_gated_options(tmp_path)[config]]
    saved = jscoring.SCORE_TYPE, tscoring.SCORE_TYPE
    try:
        jpl = JPipeline(jparse(args), io.StringIO())
        tpl = tpipe.Pipeline(tparse(args), io.StringIO())
        got = tfarm.farm_supported(tpl), tdist.dist_supported(tpl)
        want = jfarm.farm_supported(jpl), jdist.dist_supported(jpl)
    finally:
        jscoring.set_score_type(saved[0])
        tscoring.set_score_type(saved[1])
    assert got == want
    assert want[0] == (config == "default")
    assert want[1] == (config in ("default", "census"))


def test_farm_declines_process_wide_hsp_numbers(port_cpu, tmp_path):
    """The general format's hspid numbers HSPs across the process
    (align/segments.SegmentTable), so farm workers would interleave
    them: the port's gates decline it (lastz_tpu's accept it, and its
    farm then writes other numbers than its serial run), and the job
    runs serially, pinned, with the serial output."""
    from lastz_tpu_torch.align.segments import SegmentTable
    t, q = _make_inputs(tmp_path, nq=4)
    args = [t, q, "--format=general:name2,hspid,score", "--ydrop=3000"]
    tpl = tpipe.Pipeline(tparse(args), io.StringIO())
    jpl = JPipeline(jparse(args), io.StringIO())
    assert not tfarm.farm_supported(tpl) and not tdist.dist_supported(tpl)
    assert jfarm.farm_supported(jpl) and jdist.dist_supported(jpl)
    port_cpu.setattr(SegmentTable, "_hsp_id_counter", 0)
    serial, _ = port_run(args)
    SegmentTable._hsp_id_counter = 0
    pinned, pl = port_run(args, ["cpu", "cpu"], port_cpu)
    assert not getattr(pl, "_farmed", False)
    assert pinned == serial
    assert [ln.split("\t")[1] for ln in serial.splitlines()[1:]] == [
        "1", "2", "3", "4"]


def test_run_stats_merge_matches_lastz_tpu():
    def collectors(cls):
        a, b = cls(), cls()
        for i, f in enumerate(dataclasses.fields(cls)):
            if f.type in ("int", int):
                setattr(a, f.name, 3 * i + 1)
                setattr(b, f.name, 5 * i + 2)
        a.timers.update({"gapped": 1.5, "seed search": 0.25})
        b.timers.update({"gapped": 0.5, "pos table": 2.0})
        a.extra.update({"ydrop launches": 4, "note": "a"})
        b.extra.update({"ydrop launches": 3, "seed host searches": 1,
                        "note": "b", "only b": "x"})
        a.merge(b)
        return dataclasses.asdict(a)
    assert collectors(TRunStats) == collectors(JRunStats)


def test_farm_overlaps_queries(port_cpu, tmp_path):
    """The workers run their queries at the same time: with a
    GIL-releasing stand-in for device latency in every query, at least
    two queries are inside it at once (the serial run's peak is 1)."""
    t, q = _make_inputs(tmp_path, n=800, nq=6, seed=5, qlen=400)
    args = [t, q, "--format=maf", "--ydrop=1500"]
    port_cpu.setenv("LASTZ_TORCH_FARM_TEST_DELAY", "0.5")
    port_cpu.setattr(tpipe, "_FARM_TEST_PEAK", 0)
    serial, _ = port_run(args)
    assert tpipe._FARM_TEST_PEAK == 1
    tpipe._FARM_TEST_PEAK = 0
    farmed, fpl = port_run(args, ["cpu"] * 3, port_cpu)
    assert fpl._farmed and farmed == serial
    assert tpipe._FARM_TEST_PEAK >= 2, \
        f"peak in flight {tpipe._FARM_TEST_PEAK}, expected >= 2"


def test_declined_job_stays_serial_and_pinned(port_cpu, tmp_path):
    """A job farm_supported declines (census) runs the serial loop,
    each query pinned to a slot round-robin, with the serial output."""
    t, q = _make_inputs(tmp_path, n=1500, nq=4, seed=11)
    args = [t, q, "--format=maf", "--ydrop=1500", "--census"]
    serial, _ = port_run(args)
    pinned = []
    own = tpipe.Pipeline._run_query

    def run_query(self, *a):
        pinned.append(str(self.device))
        return own(self, *a)
    port_cpu.setattr(tpipe.Pipeline, "_run_query", run_query)
    farmed, fpl = port_run(args, ["cpu", "cpu", "cpu"], port_cpu)
    assert not getattr(fpl, "_farmed", False)
    assert farmed == serial
    assert len(pinned) == 4 and set(pinned) == {"cpu"}


def test_no_fallback_hides_a_slot_or_a_worker(port_cpu, tmp_path, capsys):
    """A slot naming a card where torch sees none raises, and a worker's
    failure makes the CLI exit nonzero."""
    t, q = _make_inputs(tmp_path, nq=3)
    port_cpu.setattr(tpipe, "FARM_SLOTS", ["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run([t, q])
    own = tpipe.Pipeline._run_query

    def run_query(self, target, pt, query, *a):
        if getattr(self, "_farm_worker", False) and \
                self.cfg.shard_index == 1:
            raise ValueError("worker 1 failed")
        return own(self, target, pt, query, *a)
    port_cpu.setattr(tpipe.Pipeline, "_run_query", run_query)
    port_cpu.setattr(tpipe, "FARM_SLOTS", ["cpu", "cpu"])
    capsys.readouterr()
    assert cli.main([t, q]) == 1
    assert "worker 1 failed" in capsys.readouterr().err


# one process of a two-process gloo group: the port's CLI pipeline over
# its query shard (LASTZ_TORCH_DIST=1); rank 0 keeps output and census
DIST_WORKER = r"""
import io, os, sys
rank, world, addr, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
args = sys.argv[5:]
sys.modules["jax"] = None
sys.modules["lastz_tpu"] = None
sys.path.insert(0, %(repo)r)
import numpy as np
import torch.distributed as dist
dist.init_process_group("gloo", init_method=addr, world_size=world,
                        rank=rank)
from lastz_tpu_torch.align import ydrop_device
ydrop_device.DEFAULT_WIDTH = 192
ydrop_device.DEFAULT_ROWS = 128
ydrop_device.DEFAULT_BATCH = 8
from lastz_tpu_torch.cli import parse_options
from lastz_tpu_torch.pipeline import Pipeline
buf = io.StringIO()
pl = Pipeline(parse_options(args), buf)
pl.run()
assert pl._farmed
if rank == 0:
    with open(os.path.join(outdir, "out0.lav"), "w") as f:
        f.write(buf.getvalue())
    if pl.targ_census is not None:
        np.save(os.path.join(outdir, "census0.npy"), pl.targ_census.count)
dist.destroy_process_group()
print("WORKER_DONE", rank)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("census", [False, True])
def test_two_process_gloo_run(port_cpu, tmp_path, census):
    t, q = _make_inputs(tmp_path, n=4000, nq=7, seed=11, qlen=900)
    args = [t, q, "--format=lav", "--ydrop=3000"] + (
        ["--census"] if census else [])
    addr = f"tcp://127.0.0.1:{_free_port()}"
    penv = dict(os.environ, LASTZ_TORCH_DIST="1", LASTZ_TORCH_DEVICE="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_WORKER % {"repo": REPO}, str(rank), "2",
         addr, str(tmp_path), *args], env=penv, cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append((*p.communicate(timeout=300), p.returncode))
        except subprocess.TimeoutExpired:
            for k in procs:
                k.kill()
            raise
    for out, err, rc in outs:
        assert rc == 0, err[-2000:]
        assert "WORKER_DONE" in out

    serial, spl = port_run(args)
    with open(tmp_path / "out0.lav") as f:
        got = f.read()

    def strip(s):  # the d-stanza echoes the command line
        return [ln for ln in s.splitlines() if not ln.startswith('  "')]
    assert strip(got) == strip(serial)
    assert got.count("a {") >= 7
    if census:
        np.testing.assert_array_equal(np.load(tmp_path / "census0.npy"),
                                      spl.targ_census.count)
        assert spl.targ_census.count.any()
    else:
        assert not (tmp_path / "census0.npy").exists()


def test_native_library_is_built_once_for_racing_threads(monkeypatch):
    """Two threads asking for the native library at once both get it:
    the second waits for the first's build instead of taking the
    Python tier."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    own = native._build_lib

    def slow_build():
        time.sleep(0.3)
        return own()
    monkeypatch.setattr(native, "_build_lib", slow_build)
    start = threading.Barrier(2)
    got = [None, None]

    def ask(i):
        start.wait()
        got[i] = native.get_lib()
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert got[0] is not None and got[0] is got[1]


def test_launch_counts_survive_racing_threads():
    """N threads each counting M launches leave launches == N * M."""
    def fn():
        pass
    fn.launches = 0
    fn.wide = 0
    n, m = 16, 4000
    start = threading.Barrier(n)

    def launch():
        start.wait()
        for _ in range(m):
            build.count(fn, wide=2)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(saved)
    assert fn.launches == n * m
    assert fn.wide == 2 * n * m
