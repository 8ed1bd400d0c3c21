"""The port's seed stage (lastz_tpu_torch/ops/hitgen.py,
ops/xdrop_cuda.py, search/device_hits.py) against lastz_tpu's: the
plain x-drop scan equals hitgen._xdrop_all, one hit launch equals the
JAX hit_launch (with and without the Pallas scan in interpret mode),
and the device search reports the scalar engine's and lastz_tpu's
device search's hits, in order.  Inputs come from a numpy seed; the
tolerance is exact equality (hit lists and integer scores)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lastz_tpu.config import GFEX_NO_EXTEND, GFEX_XDROP, ScoreThreshold
from lastz_tpu.core.encoding import UPPER_NUC_TO_BITS
from lastz_tpu.core.scoring import new_dna_score_set
from lastz_tpu.core.seeds import parse_seed
from lastz_tpu.index.postable import build_seed_position_table
from lastz_tpu.ops import hitgen as jh
from lastz_tpu.search.batched import _probe_xors
import lastz_tpu_torch.stats as tstats
from lastz_tpu_torch import config as tconfig
from lastz_tpu_torch.core.seeds import parse_seed as t_parse_seed
from lastz_tpu_torch.core.scoring import new_dna_score_set as t_score_set
from lastz_tpu_torch.device import SEQ_PAD, carry_state
from lastz_tpu_torch.index.postable import (
    build_seed_position_table as t_build_table)
from lastz_tpu_torch.ops import hitgen as th
from lastz_tpu_torch.search import device_hits
from lastz_tpu_torch.search.engine import HitProcessorParams as THitParams
from lastz_tpu_torch.search.engine import SeedSearchEngine

from chip_smoke import XDROP_EDGES, xdrop_edge_inputs
from test_hitgen import SCALAR, _collect, _related_pair

CPU = torch.device("cpu")


@pytest.mark.parametrize("K", [4, 5])
def test_xdrop_plain_matches_jax(K):
    """Both directions over a K-code alphabet with a K x K table."""
    rng = np.random.default_rng(K)
    n = 5000
    c1 = rng.integers(0, K, n)
    c2 = np.where(rng.random(n) < 0.8, c1, rng.integers(0, K, n))
    c2[n // 2: n // 2 + 300] = rng.integers(0, K, 300)  # a divergent run
    seq1p = np.zeros(n + 2 * SEQ_PAD, np.int8)
    seq2p = np.zeros(n + 2 * SEQ_PAD, np.int8)
    seq1p[SEQ_PAD:SEQ_PAD + n] = c1
    seq2p[SEQ_PAD:SEQ_PAD + n] = c2
    sub = np.where(np.eye(K, dtype=bool), 91, -114).astype(np.int32)
    sub[0, 1:] = rng.integers(-150, 60, K - 1)
    H = 4096
    pos1 = rng.integers(1, n, H)
    pos2 = np.where(rng.random(H) < 0.5, pos1, rng.integers(1, n, H))
    diag = pos1 - pos2
    for step, p1, p2, cells in (
            (+1, pos1, pos2, np.maximum(np.minimum(n, n + diag) - pos1, 0)),
            (-1, pos1 - 1, pos2 - 1, pos1 - np.maximum(diag, 0))):
        cells = np.where(rng.random(H) < 0.05, 0, cells)  # some dead hits
        ref = jh._xdrop_all(jnp.asarray(seq1p), jnp.asarray(seq2p),
                            jnp.asarray(sub.reshape(-1)), K,
                            *map(jnp.asarray, (p1.astype(np.int32),
                                               p2.astype(np.int32),
                                               cells.astype(np.int32))),
                            300, step)
        got = th.xdrop_scan_plain(
            torch.from_numpy(seq1p), torch.from_numpy(seq2p),
            torch.from_numpy(sub.reshape(-1)), K,
            *map(torch.from_numpy, (p1, p2, cells)), 300, step)
        for name, a, b in zip(("consumed", "best", "kbest"), ref, got):
            assert np.array_equal(np.asarray(a), b.numpy()), (step, name)
        assert int(got[0].max()) > jh.XD_FIRST  # continuation rounds ran


@pytest.mark.parametrize("case", XDROP_EDGES)
def test_xdrop_plain_edges_match_jax(case):
    """The plain scan against _xdrop_all at the edges of the CUDA
    kernel's stages and chunks (chip_smoke.XDROP_EDGES): n
    at 32- and 128-cell edges, drops at them, ties across them, walks
    that run to n; both directions."""
    (s1, s2, sub, pos1, pos2, n_l, n_r), x_drop, expect = \
        xdrop_edge_inputs(case)
    for step, p1, p2, cells in ((+1, pos1, pos2, n_r),
                                (-1, pos1 - 1, pos2 - 1, n_l)):
        ref = jh._xdrop_all(*map(jnp.asarray, (s1, s2, sub)), 4,
                            *map(jnp.asarray, (p1, p2, cells)), x_drop, step)
        got = th.xdrop_scan_plain(*map(torch.from_numpy, (s1, s2, sub)), 4,
                                  *map(torch.from_numpy, (p1, p2, cells)),
                                  x_drop, step)
        for name, a, b in zip(("consumed", "best", "kbest"), ref, got):
            assert np.array_equal(np.asarray(a), b.numpy()), (step, name)
        assert tuple(int(a[0]) for a in got) == expect, step


def _launch_inputs(s1, s2, seed_str, trans):
    """Seed-stage inputs for one launch over the whole query, built by
    both packages from the same carried state (device.carry_state)."""
    seed = parse_seed(seed_str, with_trans=trans)
    pt = build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    sc = new_dna_score_set()
    state = carry_state(s1, s2, sc.sub, CPU, pt=pt)
    L = seed.length
    codes = UPPER_NUC_TO_BITS[s2].astype(np.int8)
    xors = _probe_xors(seed)
    pk_t, vd_t = th.pack_query_words(torch.from_numpy(codes), seed.bit_map,
                                     L, seed.bits_per_base)
    pk_j, vd_j = jh.pack_query_words(jnp.asarray(codes), seed.bit_map, L,
                                     seed.bits_per_base)
    assert np.array_equal(np.asarray(pk_j).astype(np.int64), pk_t.numpy())
    assert np.array_equal(np.asarray(vd_j), vd_t.numpy())
    cum_t, ends_t, tot_t = th.pair_counts(pk_t, vd_t,
                                          torch.from_numpy(xors),
                                          state["csr_start"])
    csr_start_j = jnp.asarray(state["csr_start"].numpy())
    cum_j, ends_j, tot_j = jh.pair_counts(pk_j, vd_j,
                                          jnp.asarray(xors.astype(np.uint32)),
                                          csr_start_j)
    assert np.array_equal(np.asarray(cum_j), cum_t.numpy())
    assert np.array_equal(np.asarray(ends_j), ends_t.numpy())
    total = int(tot_t)
    H = 4096
    assert 0 < total <= H
    karr_t = th.expand_chunk(cum_t, 2 * H)
    karr_j = jh.expand_chunk(cum_j, 2 * H)
    assert np.array_equal(np.asarray(karr_j), karr_t.numpy())
    return seed, pt, state, xors, cum_t, ends_t, karr_t, total, H


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
def test_hit_launch_matches_jax(pallas, monkeypatch):
    import lastz_tpu.ops.xdrop_pallas as xp
    from lastz_tpu.search import device_hits as jdh
    s1, s2 = _related_pair(3000, seed=7, ident=0.92, with_n=False)
    seed, pt, state, xors, cum, ends, karr, total, H = _launch_inputs(
        s1, s2, "11111111111", 1)
    L = seed.length
    sub = state["subsmall"]
    de0 = np.full(65536, -1, np.int32)
    de0[::97] = 40  # some live diagonal extents
    scal = dict(hit_base=0, total=total, chunk_lo=0,
                adj_start=int(pt.adj_start), step=int(pt.step), seed_len=L,
                thresh=300, band=1 << 30, len1=len(s1), len2=len(s2))
    static = dict(x_drop=300, no_extend=False, self_compare=False,
                  same_strand=False, use_thresh=True, has_alive=False,
                  K=16, nprobe=len(xors), H=H, out_cap=512)
    extra = {}
    if pallas:
        monkeypatch.setattr(xp, "NB", 512)
        monkeypatch.setattr(xp, "LMARGIN", 2048)
        code_map = state["code_map"]
        k_real = int(code_map.max()) + 1
        seq1_rows = jdh._seq_rows32(s1, code_map)
        seq2_rows = jdh._seq_rows32(s2, code_map)
        extra = dict(seq1_rows=seq1_rows, qwin_rows=seq2_rows,
                     qoff=jnp.int32(SEQ_PAD), pallas_interpret=True,
                     sub_tuple=tuple(int(v) for v in
                                     sub[:k_real, :k_real].reshape(-1)))
    J = jnp.asarray
    de_j, _, out_j, sc_j = jh.hit_launch(
        J(state["seq1p"].numpy()), J(state["seq2p"].numpy()),
        J(sub.reshape(-1)), J(state["csr_pos"].numpy()),
        J(np.zeros(1, np.uint8)),
        J(cum.numpy().astype(np.int32)), J(ends.numpy().astype(np.int32)),
        J(karr[:H].numpy().astype(np.int32)), J(de0),
        J(np.zeros(65536, np.int32)),
        *(jnp.int32(v) for v in scal.values()), **extra, **static)
    de_t, out_t, sc_t = th.hit_launch(
        state["seq1p"], state["seq2p"], state["subsmall_t"].reshape(-1),
        state["csr_pos"], None, cum, ends, karr[:H], torch.from_numpy(de0),
        *scal.values(), **static)
    assert np.array_equal(np.asarray(sc_j)[:5], sc_t.numpy()[:5])
    assert int(sc_t[0]) > 20  # survivors exist
    assert np.array_equal(np.asarray(out_j), out_t.numpy())
    assert np.array_equal(np.asarray(de_j), de_t.numpy())


def _port_engine_inputs(s1, seed_str, trans, gf_extend, thresh, x_drop):
    """The port's seed, table and hit parameters (its own classes)."""
    seed = t_parse_seed(seed_str, with_trans=trans)
    pt = t_build_table(s1, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    hp = THitParams(gf_extend=gf_extend, scoring=t_score_set(),
                    x_drop=x_drop,
                    hsp_threshold=tconfig.ScoreThreshold("S", thresh))
    return seed, pt, hp


def _port_hits(s1, s2, seed_str, trans, gf_extend, thresh, x_drop=910,
               **kw):
    seed, pt, hp = _port_engine_inputs(s1, seed_str, trans, gf_extend,
                                       thresh, x_drop)
    hits = []
    eng = SeedSearchEngine(
        s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
        lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln,
        device=CPU, **kw)
    runs = device_hits.device_search.runs
    eng.search(0, len(s2))
    assert device_hits.device_search.runs == runs + 1  # not the host path
    return hits


JAX_DEVICE = {"LASTZ_TPU_SCALAR_SEARCH": "0", "LASTZ_TPU_HITGEN": "1",
              "LASTZ_TPU_HIT_BUDGET": str(1 << 15)}

SEARCH_CASES = {
    # name: (pair args, seed, trans, gf_extend, thresh, x_drop, engine kw)
    "trans0": ((6000,), "1110100110010101111", 0, GFEX_XDROP, 3000, 910,
               {}),
    "trans1": ((6000,), "1110100110010101111", 1, GFEX_XDROP, 3000, 910,
               {}),
    "trans2": ((6000,), "1110100110010101111", 2, GFEX_XDROP, 3000, 910,
               {}),
    "dense_chains": ((3000, 7, 0.92), "11111111", 0, GFEX_XDROP, 300, 300,
                     {}),
    "no_extend": ((2500, 5), "111111111111", 0, GFEX_NO_EXTEND, 0, 910, {}),
    "halfweight": ((4000, 13), "TTT0T0TTT0TT0TTTT", 0, GFEX_XDROP, 2000,
                   910, {}),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_device_search_matches_scalar_and_jax(case):
    pair, seed_str, trans, gfex, thresh, x_drop, kw = SEARCH_CASES[case]
    s1, s2 = _related_pair(*pair)  # with an N run
    args = (s1, s2, seed_str, trans, gfex, thresh)
    ref = _collect(*args, x_drop=x_drop, env=SCALAR)
    dev = _collect(*args, x_drop=x_drop, env=JAX_DEVICE)
    got = _port_hits(*args, x_drop=x_drop, **kw)
    assert len(ref) > 0
    assert dev == ref
    assert got == ref


def test_device_search_split_and_band(monkeypatch):
    """An output cap small enough to force the overflow split, and a
    self comparison on one strand with a band."""
    s1, s2 = _related_pair(2500, seed=5)
    args = (s1, s2, "111111111111", 0, GFEX_NO_EXTEND, 0)
    ref = _collect(*args, env=SCALAR)
    monkeypatch.setattr(device_hits, "OUT_CAP", 64)
    assert len(ref) > 64
    assert _port_hits(*args) == ref
    monkeypatch.undo()
    s1, _ = _related_pair(3000, seed=9)
    args = (s1, s1, "1110100110010101111", 1, GFEX_XDROP, 3000)
    kw = dict(self_compare=True, same_strand=True, band_width=500)
    ref = _collect(*args, env=SCALAR, self_compare=True, same_strand=True,
                   band=500)
    assert _port_hits(*args, **kw) == ref


def test_unsupported_modes_go_to_the_host_engine():
    """Recover seeds are outside the slice: the port's engine hands
    them to its own host engines and counts it."""
    s1, s2 = _related_pair(4000)
    args = (s1, s2, "1110100110010101111", 1, GFEX_XDROP, 3000)
    ref = _collect(*args, env=SCALAR, hit_mode="recover")
    seed, pt, hp = _port_engine_inputs(s1, args[2], 1, tconfig.GFEX_XDROP,
                                       3000, 910)
    hits = []
    eng = SeedSearchEngine(
        s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
        lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln,
        hit_mode="recover", device=CPU)
    st = tstats.reset()
    runs = device_hits.device_search.runs
    eng.search(0, len(s2))
    assert device_hits.device_search.runs == runs
    assert st.extra.get("seed host searches") == 1
    assert hits == ref and len(ref) > 0
