"""The port's whole default path (python -m lastz_tpu_torch.cli) on the
CPU against lastz_tpu: byte-equal output to lastz_tpu's host path and
to its device path (LASTZ_TPU_DEVICE=1) on the synthetic pairs of
tests/test_device_path.py, with a nonzero device gapped share; the
package imports and runs with JAX and lastz_tpu blocked; and asking
for a card where there is none raises."""

import io
from types import SimpleNamespace

import pytest
import torch

import lastz_tpu.align.ydrop_device as jydd
import lastz_tpu_torch.align.ydrop_device as tydd
import lastz_tpu_torch.stats as tstats
from lastz_tpu.cli import parse_options
from lastz_tpu.pipeline import Pipeline as HostPipeline
from lastz_tpu_torch import cli
from lastz_tpu_torch.device import (TARGET_COUNTERS, TargetState,
                                    carry_state, get_device)
from lastz_tpu_torch.search import device_hits

from test_device_path import _make_pair
from test_torch_isolation import run_blocked


def _host(args):
    buf = io.StringIO()
    HostPipeline(parse_options(args), buf).run()
    return buf.getvalue()


def _small_geometry(monkeypatch, mod):
    # a 512-column window and 256-row chunks: 8 retained blocks hold
    # every extension of a 4 kbp pair, at a CPU-sized cost
    monkeypatch.setattr(mod, "DEFAULT_WIDTH", 256)
    monkeypatch.setattr(mod, "DEFAULT_ROWS", 256)
    monkeypatch.setattr(mod, "DEFAULT_BATCH", 8)


@pytest.mark.parametrize("fmt", ["lav", "maf", "recoverseeds"])
def test_cli_matches_lastz_tpu_host_and_device(tmp_path, monkeypatch,
                                               capsys, fmt):
    t, q = _make_pair(tmp_path)
    args = [t, q, "--ydrop=3000"] + (
        ["--recoverseeds"] if fmt == "recoverseeds" else [f"--format={fmt}"])
    monkeypatch.delenv("LASTZ_TPU_DEVICE", raising=False)
    host_out = _host(args)

    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    _small_geometry(monkeypatch, tydd)
    runs = device_hits.device_search.runs
    capsys.readouterr()
    assert cli.main(args) == 0
    port_out = capsys.readouterr().out
    st = tstats.current
    assert device_hits.device_search.runs == runs + 2  # both strands
    assert st.gapped_device > 0, \
        f"no anchor ran on the device (host={st.gapped_host})"

    monkeypatch.setenv("LASTZ_TPU_DEVICE", "1")
    _small_geometry(monkeypatch, jydd)
    jax_dev_out = _host(args)

    assert port_out == host_out
    assert port_out == jax_dev_out


def test_runs_with_jax_blocked(tmp_path):
    """The default LAV run with `jax` and `lastz_tpu` both blocked; the
    other option sets are in test_torch_isolation.py."""
    t, q = _make_pair(tmp_path, n=1500, seed=5)
    out = run_blocked([t, q, "--ydrop=3000"])
    assert out == _host([t, q, "--ydrop=3000"])
    assert out.startswith("#:lav")


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device()
    t, q = _make_pair(tmp_path, n=500)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([t, q])
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError):
        get_device()


def test_carried_state_is_keyed_on_content():
    """An upload cache keyed on id() or data_ptr() can hand one strand
    the other's codes; the port keys on content, so an array changed in
    place is uploaded again."""
    import numpy as np
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    sub = new_dna_score_set().sub
    rng = np.random.default_rng(0)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)].copy()
    first = carry_state(seq, seq, sub, torch.device("cpu"))["seq1p"]
    first = first.clone()
    seq[100:200] = ord("A")
    second = carry_state(seq, seq, sub, torch.device("cpu"))["seq1p"]
    assert not torch.equal(first, second)
    assert torch.equal(second[20608:20608 + 3000].to(torch.int64),
                       torch.from_numpy(
                           carry_state(seq, seq, sub, torch.device("cpu"))
                           ["code_map"][seq].astype(np.int64)))


def _counts(st):
    return {k: st.extra.get(k, 0) for k in TARGET_COUNTERS}


@pytest.mark.parametrize("alive_at_start", [False, True])
def test_target_handle_equals_the_content_keyed_uploads(tmp_path,
                                                        monkeypatch,
                                                        alive_at_start):
    """The run's TargetState, kept current through the pipeline's
    masking callback, hands both stages what the content-keyed cache
    gives for the same arrays: the padded codes, rebuilt where the
    masked interval brings 'x' into the alphabet and patched where it
    does not, and the host table's alive entries (made by the first
    mask, or there from the start)."""
    import numpy as np
    from lastz_tpu_torch.cli import parse_options as port_options
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    from lastz_tpu_torch.device import (SEQ_PAD, upload_codes,
                                        upload_position_table)
    from lastz_tpu_torch.io.sequence import SequenceFile
    from lastz_tpu_torch.masking import Census
    from lastz_tpu_torch.pipeline import Pipeline

    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    t, q = _make_pair(tmp_path, n=1500, seed=5)
    pipe = Pipeline(port_options([t, q, "--masking=3"]), io.StringIO())
    target = SequenceFile(t).load()
    query = SequenceFile(q).load()
    pt = pipe._build_position_table(target)
    assert not getattr(pt, "in_place", False)  # a host table under M
    if alive_at_start:
        pt.alive = np.ones(len(pt.csr_pos), bool)
    pipe.target, pipe.pt = target, pt
    handle = pipe.target_state = TargetState(target.v, pt)
    sub = new_dna_score_set().sub
    dev = torch.device("cpu")
    census = Census(len(target.v), "B", 3)

    def same_as_content(before=None):
        mine = carry_state(target.v, query.v, sub, dev, pt=pt,
                           target=handle)
        if before is not None:
            # the cache's uploads of the arrays before the mask, found
            # by content, still hold them: a patch wrote a copy of its
            # own (a clone of the cache's tensor at its first patch)
            v0, pt0 = before
            misses = st.extra["upload misses"]
            was = carry_state(v0, query.v, sub, dev, pt=pt0)
            assert st.extra["upload misses"] == misses
            assert torch.equal(
                was["seq1p"][SEQ_PAD:SEQ_PAD + len(v0)].long(),
                torch.from_numpy(was["code_map"][v0]).long())
            assert (was["alive"] is None) == (pt0.alive is None)
            if pt0.alive is not None:
                assert torch.equal(was["alive"],
                                   torch.from_numpy(pt0.alive.view(np.uint8)))
        fresh = carry_state(target.v, query.v, sub, dev, pt=pt)
        assert np.array_equal(mine["code_map"], fresh["code_map"])
        for k in ("seq1p", "csr_start", "csr_pos"):
            assert torch.equal(mine[k], fresh[k]), k
        table = upload_position_table(pt, dev)
        assert (mine["alive"] is None) == (table["alive"] is None)
        if table["alive"] is not None:
            assert torch.equal(mine["alive"], table["alive"])
        assert torch.equal(handle.codes(mine["code_map"], dev),
                           upload_codes(target.v, mine["code_map"], dev))
        return mine

    st = tstats.reset()
    mine = same_as_content()
    assert _counts(st)["target builds"] == 3  # two codes, one table
    assert not (handle.present()[ord("x")] or mine["code_map"][ord("x")])
    for lo, hi, new_code in ((300, 340, True), (900, 960, False)):
        census.count[lo:hi] = 3
        before = _counts(st)
        before_mask = (target.v.copy(), SimpleNamespace(
            csr_start=pt.csr_start, csr_pos=pt.csr_pos, adj_start=pt.adj_start,
            step=pt.step, alive=None if pt.alive is None else pt.alive.copy()))
        assert census._mask_interval(target.v, lo, hi,
                                     pipe._on_mask_interval) == hi - lo
        assert (target.v[lo:hi] == ord("x")).all()
        mine = same_as_content(before_mask)
        after = _counts(st)
        assert mine["code_map"][ord("x")] > 0
        # 'x' new: both codes copies built again, the table patched;
        # 'x' known: all three patched
        assert after["target builds"] - before["target builds"] == (
            2 if new_code else 0)
        assert after["target patches"] - before["target patches"] == (
            1 if new_code else 3)
        assert after["target patch bytes"] > before["target patch bytes"]
    assert pt.alive is not None and not pt.alive.all()
    assert handle.generation == 2


def _port_run(args, monkeypatch, content_keyed=False):
    """The port's CLI job on the CPU, traced: its output, RunStats and
    query spans; `content_keyed` runs it with no TargetState, so every
    upload goes by content digest."""
    from lastz_tpu_torch import pipeline as tpipe
    from lastz_tpu_torch.cli import parse_options as port_options
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    _small_geometry(monkeypatch, tydd)
    with monkeypatch.context() as mp:
        if content_keyed:
            mp.setattr(tpipe, "TargetState", lambda v, pt: None)
        sink = io.StringIO()
        pipe = tpipe.Pipeline(port_options(list(args)), sink)
        with tstats.tracing() as tr:
            pipe.run()
    return (sink.getvalue(), pipe.stats,
            [s for s in tr.spans if s.name == "query"])


def test_target_handle_builds_once_and_is_reused(tmp_path, monkeypatch):
    """Four queries, no masking: the target's copies are built on the
    first query's strands only, and every later strand reuses them."""
    from test_torch_isolation import multi_query_pair
    t, q = multi_query_pair(tmp_path)
    out, st, queries = _port_run([t, q, "--ydrop=3000"], monkeypatch)
    assert out.count("a {") >= 4
    assert [s.query for s in queries] == [1, 2, 3, 4]
    assert queries[0].counts.get("target builds", 0) >= 2
    for s in queries[1:]:
        assert s.counts.get("target builds", 0) == 0, s.query
        # the seed stage's codes on both strands at least
        assert s.counts.get("target reuses", 0) >= 2, s.query
    assert st.extra["target builds"] == queries[0].counts["target builds"]
    assert st.extra["target patches"] == 0


def test_target_handle_is_patched_under_dynamic_masking(tmp_path,
                                                        monkeypatch):
    """--masking=3 --census over four overlapping queries: the census
    masks the target between queries, the handle's copies are patched,
    and the output is byte for byte the content-keyed run's."""
    from test_torch_isolation import repeated_query_pair
    t, q = repeated_query_pair(tmp_path)
    args = [t, q, "--ydrop=3000", "--masking=3", "--census"]
    out, st, _ = _port_run(args, monkeypatch)
    ref, ref_st, _ = _port_run(args, monkeypatch, content_keyed=True)
    assert st.extra["target patches"] > 0
    assert st.extra["target patch bytes"] > 0
    assert "target builds" not in ref_st.extra
    assert out == ref
    assert "x {" in out and "a {" in out


def test_target_handle_present_codes_follow_marked_writes():
    """The handle's present codes equal present_codes of the bytes as
    written, through overlapping writes, one that removes a code's last
    copy, and one between two lookups."""
    import numpy as np
    from lastz_tpu_torch.ops.ydrop_exact import present_codes
    v = np.frombuffer(b"ACGTNACGTACGTacgt", np.uint8).copy()
    handle = TargetState(v)
    assert np.array_equal(handle.present(), present_codes(v))
    for lo, hi, ch in ((2, 6, b"x"), (4, 9, b"y"), (0, 1, b"x"),
                       (13, 17, b"A")):
        handle.mark(lo, hi)
        v[lo:hi] = ord(ch)
    assert np.array_equal(handle.present(), present_codes(v))
    assert not handle.present()[ord("N")]
    handle.mark(3, 5)
    v[3:5] = ord("N")
    assert np.array_equal(handle.present(), present_codes(v))
    assert handle.generation == 5
