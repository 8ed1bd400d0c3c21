"""The port's target-sharded tier (lastz_tpu_torch/index/sharded.py,
search/sharded_mesh.py, align/ydrop_sharded.py, parallel/mesh.py) on
CPU device slots (SHARD_SLOTS = ["cpu"] * N, the counterpart of the
8-device virtual CPU mesh lastz_tpu's tests run on), held exactly
against lastz_tpu's tier on the same seeded inputs as
tests/test_sharded_index.py, test_sharded_mesh.py,
test_ydrop_sharded.py and test_multichip.py, and against the port's
own unsharded paths; and the CLI under LASTZ_TORCH_SHARDS=2 against
lastz_tpu's CLI under LASTZ_TPU_SHARDS=2."""

import contextlib
import functools
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lastz_tpu_torch.stats as tstats
from lastz_tpu.core.encoding import UPPER_NUC_TO_BITS as J_BITS
from lastz_tpu.core.scoring import new_dna_score_set as j_scores
from lastz_tpu.core.seeds import parse_seed as j_seed
from lastz_tpu_torch import cli
from lastz_tpu_torch.align import ydrop_device as tydd
from lastz_tpu_torch.align.ydrop_sharded import (ShardedTargetYDrop,
                                                 extract_target_windows)
from lastz_tpu_torch.config import GFEX_XDROP, ScoreThreshold
from lastz_tpu_torch.core.encoding import UPPER_NUC_TO_BITS
from lastz_tpu_torch.core.scoring import new_dna_score_set
from lastz_tpu_torch.core.seeds import parse_seed
from lastz_tpu_torch.index.postable import build_seed_position_table
from lastz_tpu_torch.index.sharded import (build_sharded_position_table,
                                           shard_bounds)
from lastz_tpu_torch.ops import xdrop_cuda, ydrop_cuda
from lastz_tpu_torch.parallel import mesh as tmesh
from lastz_tpu_torch.search import sharded_mesh as tsm
from lastz_tpu_torch.search.engine import HitProcessorParams, SeedSearchEngine

import test_multichip
import test_sharded_index
import test_sharded_mesh
import test_ydrop_sharded
from test_device_path import _make_pair
import torch_threads  # noqa: F401  (a share of the cores per xdist worker)

jax = pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED19 = "1110100110010101111"
CPU = torch.device("cpu")


def _slots(monkeypatch, n):
    monkeypatch.setattr(tsm, "SHARD_SLOTS", ["cpu"] * n)


@pytest.fixture(autouse=True)
def _integer_scores():
    """Both packages score in integers here, whatever a test of another
    file on this worker left behind (--scoretype=double sets a module
    global; ROADMAP C4)."""
    from lastz_tpu.core import scoring as jsc
    from lastz_tpu_torch.core import scoring as tsc
    saved = (jsc.SCORE_TYPE, tsc.SCORE_TYPE)
    jsc.set_score_type("I")
    tsc.set_score_type("I")
    yield
    jsc.set_score_type(saved[0])
    tsc.set_score_type(saved[1])


# ---------------------------------------------------------------------------
# index/sharded.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,step", [(2, 1), (4, 1), (3, 5)])
def test_sharded_tables_equal_lastz_tpu(n_shards, step):
    from lastz_tpu.index.sharded import build_sharded_position_table as jb
    s1, _ = test_sharded_index._seqs()
    got = build_sharded_position_table(
        s1, UPPER_NUC_TO_BITS, parse_seed(SEED19, with_trans=1), step,
        n_shards)
    want = jb(s1, J_BITS, j_seed(SEED19, with_trans=1), step, n_shards)
    assert len(got.shards) == len(want.shards) == n_shards
    for g, w in zip(got.shards, want.shards):
        assert (g.start, g.end, g.adj_start, g.step) == \
            (w.start, w.end, w.adj_start, w.step)
        np.testing.assert_array_equal(g.csr_start, w.csr_start)
        np.testing.assert_array_equal(g.csr_pos, w.csr_pos)
    merged = got.as_merged()
    full = build_seed_position_table(
        s1, 0, 0, UPPER_NUC_TO_BITS, parse_seed(SEED19, with_trans=1), step)
    jm = want.as_merged()
    for m in (jm, full):
        np.testing.assert_array_equal(np.asarray(merged.csr_start, np.int64),
                                      np.asarray(m.csr_start, np.int64))
        np.testing.assert_array_equal(
            merged.adj_start + merged.step * merged.csr_pos.astype(np.int64),
            m.adj_start + m.step * m.csr_pos.astype(np.int64))
    for w in np.nonzero(full.counts())[0][:50]:
        np.testing.assert_array_equal(got.positions_for(int(w)),
                                      want.positions_for(int(w)))


def test_shard_bounds_equal_lastz_tpu():
    from lastz_tpu.index.sharded import shard_bounds as jbounds
    for args in ((1000, 3, 19), (30000, 4, 19), (99, 8, 12), (50, 1, 19)):
        assert shard_bounds(*args) == jbounds(*args)


# ---------------------------------------------------------------------------
# search/sharded_mesh.py
# ---------------------------------------------------------------------------


def _engine(s1, s2, pt, hits, seed):
    sc = new_dna_score_set()
    hp = HitProcessorParams(
        gf_extend=GFEX_XDROP, scoring=sc, x_drop=910,
        hsp_threshold=ScoreThreshold("S", 3000))
    return SeedSearchEngine(
        s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
        lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln)


def _port_scalar_hits(s1, s2, step=1):
    """The port's scalar engine (its per-base oracle path): the native
    sweep and the batched search decline."""
    from unittest import mock
    seed = parse_seed(SEED19, with_trans=1)
    pt = build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS, seed, step)
    hits = []
    eng = _engine(s1, s2, pt, hits, seed)
    with mock.patch("lastz_tpu_torch.search.native_sweep.native_hit_search",
                    lambda *a: None), \
            mock.patch("lastz_tpu_torch.search.batched.batched_search",
                       lambda *a: None):
        eng.search(0, len(s2))
    return hits


@functools.cache
def _seqs_scalar_hits():
    """_port_scalar_hits on test_sharded_mesh._seqs(), once a module."""
    return _port_scalar_hits(*test_sharded_mesh._seqs())


def _port_mesh_hits(s1, s2, n_shards, halo, step=1):
    seed = parse_seed(SEED19, with_trans=1)
    sc = new_dna_score_set()
    index = tsm.MeshShardedIndex(s1, UPPER_NUC_TO_BITS, seed, step,
                                 n_shards, sc.sub, ext_halo=halo,
                                 slots=["cpu"] * n_shards)
    # the slots hold strict slices, never the whole target
    assert ((index.res_hi - index.res_lo) < len(s1)).all()
    assert len(index.codes_d) == n_shards
    assert all(t.device.type == "cpu" for t in index.codes_d)
    pt = build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS, seed, step)
    hits = []
    got = tsm.sharded_mesh_search(_engine(s1, s2, pt, hits, seed), index)
    assert got is not None
    return hits, index


def _jax_mesh(s1, s2, n_shards, halo, step=1):
    return test_sharded_mesh._mesh_hits(
        s1, s2, j_seed(SEED19, with_trans=1), n_shards, halo, step)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_search_equals_lastz_tpu_and_scalar(n_shards):
    s1, s2 = test_sharded_mesh._seqs()
    ref, jindex = _jax_mesh(s1, s2, n_shards, 2048)
    assert len(ref) > 0
    got, index = _port_mesh_hits(s1, s2, n_shards, 2048)
    assert got == ref
    assert got == _seqs_scalar_hits()
    assert index.per_device_target_bytes == jindex.per_device_target_bytes
    np.testing.assert_array_equal(index.res_lo, jindex.res_lo)
    np.testing.assert_array_equal(index.res_hi, jindex.res_hi)
    np.testing.assert_array_equal(index.cov, jindex.cov)


def test_sharded_search_halo_gather():
    """The 12 kbp exact border-crossing repeat outruns a 512-base halo:
    gathered-window re-extensions run, and the hits are still
    lastz_tpu's and the scalar engine's."""
    s1, s2 = test_sharded_mesh._seqs()
    ref, _ = _jax_mesh(s1, s2, 4, 512)
    tstats.reset()
    got, _ = _port_mesh_hits(s1, s2, 4, 512)
    assert tstats.current.extra.get("shard halo-gathers", 0) > 0
    assert got == ref == _seqs_scalar_hits()


def test_sharded_search_cap_split(monkeypatch):
    """A CAP far below a chunk's candidates splits every range until it
    fits (lastz_tpu's :463-468); the hits do not change."""
    s1, s2 = test_sharded_mesh._seqs()
    want, _ = _port_mesh_hits(s1, s2, 2, 2048)
    ranges = []
    own = tsm._mesh_program

    def counted(index, inputs, dyn, statics):
        ranges.append(dyn[1:3])
        return own(index, inputs, dyn, statics)
    monkeypatch.setattr(tsm, "_mesh_program", counted)
    monkeypatch.setattr(tsm, "CAP", 2048)
    got, _ = _port_mesh_hits(s1, s2, 2, 2048)
    assert got == want == _seqs_scalar_hits()
    n_chunks = -(-len(s2) // (1 << 14))
    assert len(ranges) > 4 * n_chunks  # split, and split again
    assert min(hi - lo for lo, hi in ranges) <= 1 << 11


def test_sharded_search_step_and_three_shards():
    s1, s2 = test_sharded_mesh._seqs(n=24000, seed=11, exact_repeat=False)
    ref, _ = _jax_mesh(s1, s2, 3, 4096, step=3)
    assert len(ref) > 0
    got, _ = _port_mesh_hits(s1, s2, 3, 4096, step=3)
    assert got == ref == _port_scalar_hits(s1, s2, step=3)


def test_gather_codes_matches_target():
    s1, _ = test_sharded_mesh._seqs(n=20000, seed=3, exact_repeat=False)
    index = tsm.MeshShardedIndex(
        s1, UPPER_NUC_TO_BITS, parse_seed(SEED19, with_trans=1), 1, 4,
        new_dna_score_set().sub, ext_halo=1024, slots=["cpu"] * 4)
    want = index.code_map[s1]
    for lo, hi in [(0, 20000), (4990, 5010), (14000, 19000),
                   (0, 1), (19999, 20000)]:
        np.testing.assert_array_equal(index.gather_codes(lo, hi),
                                      want[lo:hi])


def test_route_declines_below_the_shard_count(monkeypatch):
    """Fewer slots than shards: the route returns None, as lastz_tpu's
    does with fewer JAX devices; with enough it searches."""
    s1, s2 = test_sharded_mesh._seqs(n=20000, seed=3, exact_repeat=False)
    seed = parse_seed(SEED19, with_trans=1)
    pt = build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    _slots(monkeypatch, 1)
    assert tsm.mesh_search_via_env(_engine(s1, s2, pt, [], seed), 2) is None
    _slots(monkeypatch, 2)
    tsm._INDEX_CACHE.clear()
    assert tsm.mesh_search_via_env(_engine(s1, s2, pt, [], seed), 2) \
        is not None
    # the cache is keyed by content, not by the array's identity
    assert tsm.mesh_search_via_env(
        _engine(s1.copy(), s2, pt, [], seed), 2) is not None
    assert len(tsm._INDEX_CACHE) == 1


# ---------------------------------------------------------------------------
# align/ydrop_sharded.py
# ---------------------------------------------------------------------------


def _yd_index(s1, n_shards=4, halo=2048):
    return tsm.MeshShardedIndex(
        s1, UPPER_NUC_TO_BITS, parse_seed(SEED19, with_trans=1), 1,
        n_shards, new_dna_score_set().sub, ext_halo=halo,
        slots=["cpu"] * n_shards)


def test_extract_windows_equal_lastz_tpu():
    """Owner-gathered windows equal lastz_tpu's and the coded target's
    slices, at the sequence's edges and across shard borders."""
    from lastz_tpu.align.ydrop_sharded import extract_target_windows as jx
    s1, _ = test_ydrop_sharded._seqs()
    index = _yd_index(s1)
    jindex = test_ydrop_sharded._index(s1)
    assert ((index.res_hi - index.res_lo) < len(s1)).all()
    codes = index.code_map[s1].astype(np.int8)
    n = len(s1)
    Wt = 520
    rng = np.random.default_rng(3)
    lo = np.concatenate([
        rng.integers(0, n - Wt, 24),
        np.array([0, n - Wt]),
        np.array([7500 - Wt // 2, 15000 - Wt // 2,
                  22500 - Wt // 2, 7499, 14999]),
    ]).astype(np.int64)
    for keys in (lo, np.minimum(lo + Wt - 1, n - 1)):
        got = extract_target_windows(index, lo, keys, Wt).numpy()
        np.testing.assert_array_equal(got, np.asarray(jx(jindex, lo, keys,
                                                         Wt)))
        np.testing.assert_array_equal(
            got, np.stack([codes[int(p): int(p) + Wt] for p in lo]))


def _small_gapped(monkeypatch, rows):
    monkeypatch.setattr(tydd, "DEFAULT_WIDTH", 256)
    monkeypatch.setattr(tydd, "DEFAULT_ROWS", rows)
    monkeypatch.setattr(tydd, "DEFAULT_BATCH", 8)


def test_sharded_ydrop_equals_lastz_tpu_and_whole(monkeypatch):
    """ShardedTargetYDrop, lane for lane (every result field and the
    traceback ops), equals lastz_tpu's and the port's whole-target
    DeviceYDrop; the extensions outrun the retained blocks, so the
    continuation launches re-extract their windows."""
    from lastz_tpu.align.ydrop_sharded import ShardedTargetYDrop as JShard
    s1, s2 = test_ydrop_sharded._seqs()
    seg_infos = [(a1, a2, 0, len(s1), 0, len(s2)) for a1, a2 in
                 [(2600, 1000), (5000, 3400), (8500, 6900), (14000, 8400),
                  (16800, 11200)]]
    jshard = JShard(test_ydrop_sharded._index(s1), s1, s2, j_scores(),
                    3400, False, 80 << 20, list(seg_infos), width=256,
                    rows=64, batch=8)
    _small_gapped(monkeypatch, 64)
    sc = new_dna_score_set()
    whole = tydd.DeviceYDrop(s1, s2, sc, 3400, False, 80 << 20,
                             list(seg_infos), CPU)
    shard = ShardedTargetYDrop(_yd_index(s1), s1, s2, sc, 3400, False,
                               80 << 20, list(seg_infos), CPU)
    assert jshard.ok and whole.ok and shard.ok
    calls = []
    own = shard._target_args

    def seen(A1, LO1, HI1, REV, row0, rows, max_blocks):
        calls.append(row0.copy())
        return own(A1, LO1, HI1, REV, row0, rows, max_blocks)
    shard._target_args = seen
    for k in range(len(seg_infos)):
        for ref in (whole, jshard):
            rw, rs = ref.result_for(k), shard.result_for(k)
            for side in ("fwd", "rev"):
                for key in rw[side]:
                    assert np.all(np.asarray(rw[side][key])
                                  == np.asarray(rs[side][key])), \
                        (k, side, key)
            assert ref._ops[k] == shard._ops[k], k
    assert int(whole._results[0]["fwd"]["row"]) > \
        whole.max_blocks * whole.rows
    # one first launch, then continuations at advanced rows
    assert len(calls) > 1 and (calls[0] == 0).all() and calls[1].min() > 0


def test_sharded_ydrop_rejects_small_halo(monkeypatch):
    """A residency halo narrower than one launch's read band is refused
    (ok = False), as lastz_tpu refuses it."""
    from lastz_tpu.align.ydrop_sharded import ShardedTargetYDrop as JShard
    s1, s2 = test_ydrop_sharded._seqs(n=24000, seed=9)
    seg = [(5000, 1000, 0, len(s1), 0, len(s2))]
    _small_gapped(monkeypatch, 256)
    shard = ShardedTargetYDrop(_yd_index(s1, halo=512), s1, s2,
                               new_dna_score_set(), 3400, False, 80 << 20,
                               list(seg), CPU)
    jshard = JShard(test_ydrop_sharded._index(s1, halo=512), s1, s2,
                    j_scores(), 3400, False, 80 << 20, list(seg), width=256,
                    rows=256, batch=8)
    assert not shard.ok and not jshard.ok
    wide = ShardedTargetYDrop(_yd_index(s1, halo=2048 + 8), s1, s2,
                              new_dna_score_set(), 3400, False, 80 << 20,
                              list(seg), CPU)
    assert wide.ok


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots", [1, 4])
def test_mesh_step_equals_lastz_tpu(n_slots):
    """The step on 1 and 4 CPU slots equals lastz_tpu's on 1 and 4
    virtual devices, every output (K2's kbest is not among them)."""
    want = test_multichip._run_mesh(n_slots)
    _, _, inp = test_multichip._real_inputs()
    seed = parse_seed(SEED19, with_trans=0)
    launches = (xdrop_cuda.xdrop_scan.launches,
                ydrop_cuda.ydrop_chunk.launches)
    step = tmesh.make_sharded_pipeline(["cpu"] * n_slots, seed,
                                       gap_e=inp["gap_e"],
                                       gap_oe=inp["gap_oe"])
    got = step(inp["q_codes"], inp["t_codes"], inp["csr_start"],
               inp["sub4"], inp["subsmall"], inp["anchors12"], inp["state"],
               inp["a_small"], inp["b_small"])
    names = ["counts", "hsp_score", "ydrop_score", "end1", "end2",
             "census", "total_hits"]
    for name, a, b in zip(names, want, got):
        assert np.array_equal(a, b.numpy()), name
    assert int(got[6]) > 0 and (got[2] > 0).any()
    # the plain versions ran: a wrapper counts launches of its kernel only
    assert (xdrop_cuda.xdrop_scan.launches,
            ydrop_cuda.ydrop_chunk.launches) == launches


def test_mesh_inputs_equal_lastz_tpu():
    from lastz_tpu.parallel.mesh import build_mesh_inputs as jbuild
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    target = alpha[rng.integers(0, 4, 6000)]
    queries = [target[p: p + 400].copy()
               for p in rng.integers(0, 5000, 4)]
    got = tmesh.build_mesh_inputs(
        target, queries, parse_seed(SEED19, with_trans=0),
        new_dna_score_set(), 2, 2, 400, 2)
    want = jbuild(target, queries, j_seed(SEED19, with_trans=0),
                  j_scores(), 2, 2, 400, 2)
    assert got.keys() == want.keys()
    for k in got:
        if k == "state":
            for s in got[k]:
                np.testing.assert_array_equal(got[k][s], want[k][s])
        else:
            np.testing.assert_array_equal(got[k], want[k])


def test_pack_words_equals_lastz_tpu():
    """Word packing keeps lastz_tpu's uint32 arithmetic: a 19-base
    window's high bits are lost the same way."""
    import jax.numpy as jnp
    from lastz_tpu.parallel.mesh import pack_words_jnp
    rng = np.random.default_rng(1)
    codes = rng.integers(-1, 4, (3, 200)).astype(np.int32)
    codes[codes == -1] = rng.integers(0, 4, int((codes == -1).sum()))
    codes[0, 17] = -1
    for spec, trans in ((SEED19, 0), (SEED19, 1), ("1" * 12, 0),
                        ("1" * 15, 0)):
        jp, jv = pack_words_jnp(jnp.asarray(codes),
                                j_seed(spec, with_trans=trans))
        tp, tv = tmesh.pack_words(torch.from_numpy(codes),
                                  parse_seed(spec, with_trans=trans))
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


# ---------------------------------------------------------------------------
# the CLI under LASTZ_TORCH_SHARDS
# ---------------------------------------------------------------------------


def _host_sharded(args):
    """lastz_tpu's CLI in a child process under LASTZ_TPU_SHARDS=2 (and
    the same 512-base halo), on the 8-device virtual CPU mesh."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LASTZ_TPU_")}
    env.update(LASTZ_TPU_SHARDS="2", LASTZ_TPU_SHARD_HALO="512",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "lastz_tpu.cli", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("opts", [[], ["--recoverseeds"]])
def test_cli_sharded_equals_lastz_tpu(tmp_path, monkeypatch, opts):
    """The port in this process under LASTZ_TORCH_SHARDS=2 on two CPU
    slots writes lastz_tpu's bytes; the default run goes through the
    sharded search ("shard search" timed), --recoverseeds is declined
    (the standard tiers run, as in lastz_tpu)."""
    t, q = _make_pair(tmp_path, n=8000, seed=3)
    args = [t, q, "--ydrop=3000", *opts]
    want = _host_sharded(args)
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("LASTZ_TORCH_SHARDS", "2")
    monkeypatch.setattr(tsm, "EXT_HALO", 512)
    _slots(monkeypatch, 2)
    monkeypatch.setattr(tydd, "DEFAULT_WIDTH", 256)
    monkeypatch.setattr(tydd, "DEFAULT_ROWS", 256)
    monkeypatch.setattr(tydd, "DEFAULT_BATCH", 8)
    tsm._INDEX_CACHE.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(args) == 0
    assert out.getvalue() == want
    assert "a {" in want
    timers = tstats.current.timers
    if opts:
        assert "shard search" not in timers
    else:
        assert timers.get("shard search", 0) > 0
        assert "shard index build" in timers
        assert not tstats.current.extra.get("seed host searches")
