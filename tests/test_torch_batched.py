"""The port's batched seed search on its device: batch_xdrop_device
(lastz_tpu_torch/ops/xdrop_batch.py, K2 or its plain version) against
lastz_tpu's batch_xdrop_jax (JAX on the CPU) and batch_xdrop_np, and
the search's device branch, taken for --twins and quantum queries.
Inputs come from a numpy seed; the tolerance is exact equality (integer
scan lengths, scores and ends)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lastz_tpu.cli import parse_options
from lastz_tpu.core.scoring import new_dna_score_set
from lastz_tpu.ops.xdrop_batch import batch_xdrop_jax, batch_xdrop_np
from lastz_tpu.pipeline import Pipeline as HostPipeline
from lastz_tpu_torch import cli
from lastz_tpu_torch.align import ydrop_device as tydd
from lastz_tpu_torch.ops import xdrop_batch as txb

from test_device_path import _make_pair
from test_torch_isolation import QSCORES, quantum_pair
import torch_threads  # noqa: F401  (a share of the cores per xdist worker)

KEYS = ("left_consumed", "left_score", "left_start", "right_consumed",
        "right_score", "right_stop")


def _related(rng, n, symbols, div):
    s1 = symbols[rng.integers(0, len(symbols), n)]
    s2 = s1.copy()
    mut = rng.random(n) < div
    s2[mut] = symbols[rng.integers(0, len(symbols), int(mut.sum()))]
    return s1, s2


def _hits(rng, L1, L2, H):
    """H hits (end positions): half on the main diagonal, half random,
    plus hits at position 0 and at each sequence's end (scans of no
    cell)."""
    pos1 = rng.integers(1, L1, H)
    pos2 = np.where(rng.random(H) < 0.5, np.minimum(pos1, L2 - 1),
                    rng.integers(1, L2, H))
    edge1 = np.array([0, 0, L1, L1, 0, L1, L1 // 2])
    edge2 = np.array([0, L2, 0, L2, L2 // 2, L2 // 2, 0])
    return np.concatenate([pos1, edge1]), np.concatenate([pos2, edge2])


def _case(name):
    """(seq1, seq2, sub (256, 256) int64, pos1, pos2, x_drop, K)."""
    rng = np.random.default_rng(["dna", "wide40", "ties"].index(name))
    if name == "dna":
        # lowercase and N beside ACGT: 11 codes with NUL
        sub = new_dna_score_set().sub
        s1, s2 = _related(rng, 3000, np.frombuffer(b"ACGTacgtNn", np.uint8),
                          0.15)
        x_drop, K = 910, 16
    elif name == "wide40":
        # 40 symbols, a match-heavy random table: K2's wide instantiation
        sym = np.arange(65, 105, dtype=np.uint8)
        sub = rng.integers(-60, 20, (256, 256)).astype(np.int64)
        sub[sym, sym] = rng.integers(40, 100, len(sym))
        s1, s2 = _related(rng, 2500, sym, 0.2)
        x_drop, K = 400, 41
    else:
        # +-1 scores: the best sum is reached again and again (ties), and
        # an x_drop larger than any sum runs every scan to its end
        sub = np.full((256, 256), -1, np.int64)
        sym = np.frombuffer(b"AC", np.uint8)
        sub[sym, sym] = 1
        s1, s2 = _related(rng, 1200, sym, 0.3)
        x_drop, K = 10 ** 6, 16
    pos1, pos2 = _hits(rng, len(s1), len(s2), 4000)
    return s1, s2, sub, pos1, pos2, x_drop, K


@pytest.mark.parametrize("name", ["dna", "wide40", "ties"])
def test_batch_xdrop_device_matches_jax_and_numpy(name):
    s1, s2, sub, pos1, pos2, x_drop, K = _case(name)
    dev = torch.device("cpu")
    assert txb.device_codes(s1, s2, sub, dev)[3] == K
    got = txb.batch_xdrop_device(s1, s2, sub, pos1, pos2, x_drop, dev)
    jax_out = batch_xdrop_jax(jnp.asarray(s1), jnp.asarray(s2),
                              jnp.asarray(sub.astype(np.int32)), pos1, pos2,
                              x_drop)
    np_out = batch_xdrop_np(s1, s2, sub, pos1, pos2, x_drop)
    assert sorted(got) == sorted(KEYS)
    for ref in (jax_out, np_out):
        for k in KEYS:
            assert got[k].dtype == np.int64, k
            assert np.array_equal(got[k], np.asarray(ref[k])), k
    # every kind of scan occurred: none, cut by the drop, run to the end
    n_r = np.maximum(np.minimum(len(s1), len(s2) + pos1 - pos2) - pos1, 0)
    assert (n_r == 0).any()
    assert (got["right_consumed"] == n_r).any()
    if name != "ties":
        assert ((got["right_consumed"] > 0)
                & (got["right_consumed"] < n_r)).any()


def _host(args):
    buf = io.StringIO()
    HostPipeline(parse_options(args), buf).run()
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["twins", "quantum"])
def test_batched_search_takes_the_device_branch(tmp_path, monkeypatch,
                                                capsys, mode):
    """On the port's device (the CPU here) --twins and a quantum query
    extend their hits through batch_xdrop_device and never through the
    host scans, with output equal to lastz_tpu's host path."""
    if mode == "twins":
        t, q = _make_pair(tmp_path, n=1500, seed=5)
        args = [t, q, "--ydrop=3000", "--twins=20..200"]
    else:
        t, q = quantum_pair(tmp_path)
        args = [t, q, f"Q={QSCORES}"]
    monkeypatch.delenv("LASTZ_TPU_DEVICE", raising=False)
    want = _host(args)
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tydd, "DEFAULT_WIDTH", 128)
    monkeypatch.setattr(tydd, "DEFAULT_ROWS", 256)
    monkeypatch.setattr(tydd, "DEFAULT_BATCH", 4)
    calls = {}

    def count(name):
        own = getattr(txb, name)

        def fn(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return own(*a, **kw)
        monkeypatch.setattr(txb, name, fn)

    for name in ("batch_xdrop_device", "batch_xdrop_native",
                 "batch_xdrop_np"):
        count(name)
    capsys.readouterr()
    assert cli.main(args) == 0
    assert capsys.readouterr().out == want
    assert "a {" in want
    assert calls == {"batch_xdrop_device": 2}  # both strands
