"""The port's target index (lastz_tpu_torch/index/postable.py,
index/capsule.py, pipeline._build_position_table) against lastz_tpu's:
the device build, run as plain torch on the CPU, equals lastz_tpu's
build_seed_position_table_device (JAX on the CPU) and the port's host
build; the pipeline routes the build to the device under lastz_tpu's
gate; a default run never fetches the device table to the host; and a
capsule opened onto the device holds lastz_tpu's CSR, memoized per path
and mtime.  Inputs come from a numpy seed; the tolerance is exact
equality."""

import io
import os

import numpy as np
import pytest
import torch

import lastz_tpu.align.ydrop_device as jydd
import lastz_tpu.index.postable as jpost
import lastz_tpu.pipeline as jpipe
import lastz_tpu_torch.align.ydrop_device as tydd
import lastz_tpu_torch.pipeline as tpipe
from lastz_tpu.cli import parse_options
from lastz_tpu.core.encoding import UPPER_NUC_TO_BITS
from lastz_tpu.core.seeds import parse_seed
from lastz_tpu.index.capsule import open_capsule_file
from lastz_tpu.pipeline import Pipeline as HostPipeline
from lastz_tpu_torch import cli
from lastz_tpu_torch.cli import parse_options as t_parse_options
from lastz_tpu_torch.core.seeds import parse_seed as t_parse_seed
from lastz_tpu_torch.index import capsule as tcap
from lastz_tpu_torch.index.postable import (
    DevicePositionTable, build_seed_position_table,
    build_seed_position_table_device)

from test_device_path import _make_pair
import torch_threads  # noqa: F401  (a share of the cores per xdist worker)

CPU = torch.device("cpu")


def _target(n=30_000, seed=3):
    """Random ACGT with N runs and lowercase runs."""
    rng = np.random.default_rng(seed)
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for a in rng.integers(0, n - 400, 12):
        s[a: a + rng.integers(1, 300)] = ord("N")
    for a in rng.integers(0, n - 900, 12):
        s[a: a + rng.integers(1, 800)] |= 0x20
    return s


# (pattern, transitions, step): 12of19 with transitions, a contiguous
# 11-mer, the half-weight transition seed
BUILD_CASES = [(p, t, st)
               for p, t in (("1110100110010101111", 1), ("11111111111", 0),
                            ("TTT0T0TTT0TT0TTTT", 0))
               for st in (1, 3)]


@pytest.mark.parametrize("pattern,trans,step", BUILD_CASES)
def test_device_build_matches_jax_and_host(pattern, trans, step):
    s = _target()
    jseed = parse_seed(pattern, with_trans=trans)
    tseed = t_parse_seed(pattern, with_trans=trans)
    ref = jpost.build_seed_position_table_device(
        s, 0, 0, UPPER_NUC_TO_BITS, jseed, step)
    host = build_seed_position_table(s, 0, 0, UPPER_NUC_TO_BITS, tseed, step)
    got = build_seed_position_table_device(s, 0, 0, UPPER_NUC_TO_BITS, tseed,
                                           step, device=CPU)
    n = got.n_entries
    assert n == ref.n_entries == len(host.csr_pos) > 0
    assert got.dev_csr_start.dtype == got.dev_csr_pos.dtype == torch.int32
    assert got.dev_csr_pos.shape[0] == np.asarray(ref.dev_csr_pos).shape[0]
    assert np.array_equal(got.dev_csr_start.numpy(),
                          np.asarray(ref.dev_csr_start))
    assert np.array_equal(got.dev_csr_pos[:n].numpy(),
                          np.asarray(ref.dev_csr_pos)[:n])
    assert np.array_equal(got.csr_start, host.csr_start)
    assert np.array_equal(got.csr_pos.astype(np.int64),
                          host.csr_pos.astype(np.int64))
    assert (got.adj_start, got.step, got.num_words) == (
        host.adj_start, host.step, host.num_words)


def test_device_table_fetches_lazily_and_counts():
    s = _target(5000)
    seed = t_parse_seed("1110100110010101111")
    pt = build_seed_position_table_device(s, 0, 0, UPPER_NUC_TO_BITS, seed,
                                          device=CPU)
    DevicePositionTable.host_fetches = 0
    assert pt.in_place
    pt.csr_start, pt.csr_pos
    pt.csr_start, pt.csr_pos
    assert DevicePositionTable.host_fetches == 2  # once each
    assert pt.in_place
    pt.csr_pos = pt.csr_pos[:-1]
    assert not pt.in_place  # an assigned host array is the table now


# name: (arguments, change to the parsed config); each case breaks one
# condition of the device route (lastz_tpu/pipeline.py:789-798)
_TQ = ["t.fa", "q.fa"]
ROUTE_CASES = {
    "default": (_TQ, None),
    "overweight": (_TQ + ["--word=20"], None),
    "rev_comp": (_TQ, "rev_comp"),
    "weight_28": (_TQ + ["--seed=match14"], None),
    "writecapsule": (["t.fa", "--writecapsule=x.cap"], None),
    "showtable": (_TQ + ["--showtable"], None),
    "maxwordcount": (_TQ + ["--maxwordcount=10"], None),
    "maxwordcount_pct": (_TQ + ["--maxwordcount=90%"], None),
    "masking": (_TQ + ["--masking=3"], None),
    "target_2g": (_TQ, "big_target"),
}


def _route(pipeline_cls, parse, opts, change, monkeypatch, module, dev_mod):
    """'device' or 'host': which build function the pipeline's
    _build_position_table calls (both are replaced by recorders)."""
    called = []
    monkeypatch.setattr(module, "build_seed_position_table",
                        lambda *a, **k: called.append("host"))
    monkeypatch.setattr(dev_mod, "build_seed_position_table_device",
                        lambda *a, **k: called.append("device"))
    cfg = parse(list(opts))
    pipe = pipeline_cls(cfg, io.StringIO())
    if change == "rev_comp":
        cfg.seed.rev_comp = True

    class Target:
        v = np.zeros(100, np.uint8)
    if change == "big_target":
        Target.v = np.broadcast_to(np.uint8(65), (1 << 31,))
    pipe._build_position_table(Target())
    assert len(called) == 1
    return called[0]


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_index_route_matches_lastz_tpu(case, monkeypatch):
    opts, change = ROUTE_CASES[case]
    monkeypatch.setattr(jydd, "device_enabled", lambda: True)
    monkeypatch.delenv("LASTZ_TPU_DEV_PT", raising=False)
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    ref = _route(jpipe.Pipeline, parse_options, opts, change, monkeypatch,
                 jpipe, jpost)
    got = _route(tpipe.Pipeline, t_parse_options, opts, change, monkeypatch,
                 tpipe, tpipe)
    assert got == ref == ("device" if case == "default" else "host")


def test_default_run_never_fetches_the_device_table(tmp_path, monkeypatch,
                                                    capsys):
    """The default CLI run on the CPU builds a DevicePositionTable and
    searches it in place: no host fetch of its CSR."""
    t, q = _make_pair(tmp_path, n=2000, seed=5)
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tydd, "DEFAULT_WIDTH", 256)
    monkeypatch.setattr(tydd, "DEFAULT_ROWS", 256)
    monkeypatch.setattr(tydd, "DEFAULT_BATCH", 8)
    built = []
    own = tpipe.build_seed_position_table_device
    monkeypatch.setattr(tpipe, "build_seed_position_table_device",
                        lambda *a, **k: built.append(own(*a, **k))
                        or built[-1])
    DevicePositionTable.host_fetches = 0
    assert cli.main([t, q, "--ydrop=3000"]) == 0
    assert capsys.readouterr().out.startswith("#:lav")
    assert len(built) == 1 and isinstance(built[0], DevicePositionTable)
    assert DevicePositionTable.host_fetches == 0


def _write_capsule(tmp_path, t):
    cap = str(tmp_path / "t.cap")
    out = io.StringIO()
    HostPipeline(parse_options([t, f"--writecapsule={cap}"]), out).run()
    assert "capsule written" in out.getvalue()
    return cap


def test_capsule_on_the_device_holds_lastz_tpus_csr(tmp_path):
    t, _ = _make_pair(tmp_path, n=3000)
    cap = _write_capsule(tmp_path, t)
    _, ref = open_capsule_file(cap)
    target, pt, dev = tcap.open_capsule_to_device(cap, CPU)
    assert isinstance(pt, DevicePositionTable) and pt.in_place
    assert pt.dev_csr_start is dev.csr_start and pt.dev_csr_pos is dev.csr_pos
    assert np.array_equal(dev.csr_start.numpy(), ref.csr_start)
    assert np.array_equal(dev.csr_pos.numpy(), ref.csr_pos.astype(np.int64))
    DevicePositionTable.host_fetches = 0
    assert np.array_equal(pt.csr_pos, ref.csr_pos)  # the capsule's own map
    assert DevicePositionTable.host_fetches == 0
    assert pt.n_entries == len(ref.csr_pos)
    # memoized per path and mtime; a new mtime loads the file again
    assert tcap.open_capsule_to_device(cap, CPU)[2] is dev
    st = os.stat(cap)
    os.utime(cap, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    again = tcap.open_capsule_to_device(cap, CPU)
    assert again[2] is not dev
    assert torch.equal(again[2].csr_pos, dev.csr_pos)


def test_capsule_runs_reuse_the_device_index(tmp_path, monkeypatch):
    """Two --targetcapsule runs in one process share one DeviceIndex,
    and both write lastz_tpu's output."""
    t, q = _make_pair(tmp_path, n=1500, seed=5)
    cap = _write_capsule(tmp_path, t)
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tydd, "DEFAULT_WIDTH", 256)
    monkeypatch.setattr(tydd, "DEFAULT_ROWS", 256)
    monkeypatch.setattr(tydd, "DEFAULT_BATCH", 8)
    args = [f"--targetcapsule={cap}", q, "--ydrop=3000"]
    ref = io.StringIO()
    HostPipeline(parse_options(args), ref).run()
    seen = []
    for _ in range(2):
        out = io.StringIO()
        pipe = tpipe.Pipeline(t_parse_options(args), out)
        pipe.run()
        assert out.getvalue() == ref.getvalue()
        seen.append(pipe.device_index)
    assert seen[0] is seen[1]
