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

from chip_smoke import (CHAIN_EDGES, XDROP_EDGES, chain_edge_inputs,
                        chain_walk_args, xdrop_edge_inputs)
from test_hitgen import SCALAR, _collect, _collect_seed, _related_pair

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


# the chain cap of the edge cases on the CPU: the lockstep walks of
# both packages at their own cap of 16384 take minutes here
SMALL_CAP = 64


@pytest.mark.parametrize("recover", [False, True], ids=["simple", "recover"])
@pytest.mark.parametrize("case", CHAIN_EDGES)
def test_chain_walk_matches_jax(case, recover, monkeypatch):
    """The plain chain walks (_resolve_chains, _resolve_chains_recover)
    against lastz_tpu's device while_loops on the edge cases of
    chip_smoke.CHAIN_EDGES, both at a chain cap of SMALL_CAP."""
    monkeypatch.setattr(jh, "RESOLVE_CHAIN_CAP", SMALL_CAP)
    monkeypatch.setattr(th, "RESOLVE_CHAIN_CAP", SMALL_CAP)
    arrays = chain_edge_inputs(case, SMALL_CAP)
    args = chain_walk_args(arrays, recover)
    key, extent, start2, diag, live = arrays[:5]
    seg = np.concatenate([[True], key[1:] != key[:-1]])
    J = jnp.asarray
    if recover:
        starts, lens, _, _, de0, _, _, da0 = args
        ref = jh._resolve_chains_recover_dev(
            J(extent), J(start2), J(diag), J(de0.numpy()), J(da0.numpy()),
            J(seg), J(live))
        got = th._resolve_chains_recover(
            extent_s=args[2], start2_s=args[3], diag_s=args[6], de0_s=de0,
            da0_s=da0, starts=starts, lens=lens, live_s=args[5])
        alive, de_before, fin_de, fin_da, conv = got
        valid = np.asarray(ref[4])
        assert np.array_equal(valid, (lens > 0).numpy())
        # per-chain end states, where the scatter-back reads them
        assert np.array_equal(np.asarray(ref[2])[valid], fin_de.numpy()[valid])
        assert np.array_equal(np.asarray(ref[3])[valid], fin_da.numpy()[valid])
        ref = (ref[0], ref[1], ref[5])
    else:
        starts, lens, _, _, de0, _ = args
        ref = jh._resolve_chains_dev(J(extent), J(start2), J(de0.numpy()),
                                     J(seg), J(live))
        alive, de_before, conv = th._resolve_chains(
            args[2], args[3], de0, starts, lens, args[5])
    assert np.array_equal(np.asarray(ref[0]), alive.numpy())
    assert np.array_equal(np.asarray(ref[1]), de_before.numpy())
    assert bool(ref[2]) == conv == (case != "cap_over")
    if case not in ("empty", "single"):
        assert not alive.numpy()[live].all()  # the walk dropped hits


def _launch_inputs(s1, s2, seed, H=4096):
    """Seed-stage inputs for one launch over the whole query, built by
    both packages from the same carried state (device.carry_state)."""
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
    assert 0 < total <= H
    karr_t = th.expand_chunk(cum_t, 2 * H)
    karr_j = jh.expand_chunk(cum_j, 2 * H)
    assert np.array_equal(np.asarray(karr_j), karr_t.numpy())
    return pt, state, xors, codes, cum_t, ends_t, karr_t, total


# name: (seed pattern, max index bits, trans, recover); "pallas" runs
# lastz_tpu's scan as its Pallas kernel in interpret mode, "resolve" is
# an overweight seed (4 resolving positions)
LAUNCH_CASES = {
    "xla": ("11111111111", 28, 1, False),
    "pallas": ("11111111111", 28, 1, False),
    "recover": ("11111111111", 28, 1, True),
    "resolve": ("111011011010111", 16, 1, False),
}


@pytest.mark.parametrize("mode", list(LAUNCH_CASES))
def test_hit_launch_matches_jax(mode, monkeypatch):
    import lastz_tpu.ops.xdrop_pallas as xp
    from lastz_tpu.search import device_hits as jdh
    from lastz_tpu.search.batched import _probe_budgets
    pattern, bits, trans, recover = LAUNCH_CASES[mode]
    s1, s2 = _related_pair(3000, seed=7, ident=0.92, with_n=False)
    seed = parse_seed(pattern, bits, with_trans=trans)
    H = 4096
    pt, state, xors, codes, cum, ends, karr, total = _launch_inputs(
        s1, s2, seed, H)
    L = seed.length
    sub = state["subsmall"]
    rng = np.random.default_rng(5)
    de0 = np.full(65536, -1, np.int32)
    de0[::97] = 40  # some live diagonal extents
    da0 = np.zeros(65536, np.int32)
    if recover:
        # extents past many hits, on the hits' own diagonal (dropped) or
        # on another diagonal of the same hash (kept, unblocked left);
        # the related pair's own hits are on diagonal 0
        hs = np.arange(7, 65536, 7)
        de0[hs] = rng.integers(0, 2500, len(hs))
        da0[hs] = np.where(rng.random(len(hs)) < 0.5, hs, hs - 65536)
        de0[0], da0[0] = 300, 0
    scal = dict(hit_base=0, total=total, chunk_lo=0,
                adj_start=int(pt.adj_start), step=int(pt.step), seed_len=L,
                thresh=300, band=1 << 30, len1=len(s1), len2=len(s2))
    static = dict(x_drop=300, no_extend=False, self_compare=False,
                  same_strand=False, use_thresh=True, has_alive=False,
                  K=16, nprobe=len(xors), H=H, out_cap=512, recover=recover,
                  has_resolve=seed.type == "R")
    res_j = res_t = {}
    if seed.type == "R":
        assert len(seed.resolve_bits) > 0
        rmap = tuple((int(src), i) for i, src in enumerate(seed.resolve_bits))
        qres_t, _ = th.pack_query_words(torch.from_numpy(codes), rmap, L,
                                        seed.bits_per_base)
        qres_j, _ = jh.pack_query_words(jnp.asarray(codes), rmap, L,
                                        seed.bits_per_base)
        budgets = _probe_budgets(seed)
        res_j = dict(csr_resolve=jnp.asarray(pt.csr_resolve.astype(np.uint32)),
                     q_resolve=qres_j.astype(jnp.uint32),
                     budgets=jnp.asarray(budgets.astype(np.int32)))
        res_t = dict(csr_resolve=torch.from_numpy(
            pt.csr_resolve.astype(np.uint32).view(np.int32)),
            q_resolve=qres_t, budgets=torch.from_numpy(budgets))
    extra = {}
    if mode == "pallas":
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
    de_j, da_j, out_j, sc_j = jh.hit_launch(
        J(state["seq1p"].numpy()), J(state["seq2p"].numpy()),
        J(sub.reshape(-1)), J(state["csr_pos"].numpy()),
        J(np.zeros(1, np.uint8)),
        J(cum.numpy().astype(np.int32)), J(ends.numpy().astype(np.int32)),
        J(karr[:H].numpy().astype(np.int32)), J(de0), J(da0),
        *(jnp.int32(v) for v in scal.values()), **extra, **res_j, **static)
    de_t, da_t, out_t, sc_t = th.hit_launch(
        state["seq1p"], state["seq2p"], state["subsmall_t"].reshape(-1),
        state["csr_pos"], None, cum, ends, karr[:H], torch.from_numpy(de0),
        torch.from_numpy(da0), *scal.values(), **res_t, **static)
    assert np.array_equal(np.asarray(sc_j)[:5], sc_t.numpy()[:5])
    assert int(sc_t[0]) > 20  # survivors exist
    assert int(sc_t[4]) == 1  # converged: the state advanced
    assert np.array_equal(np.asarray(out_j), out_t.numpy())
    assert np.array_equal(np.asarray(de_j), de_t.numpy())
    assert np.array_equal(np.asarray(da_j), da_t.numpy())
    if recover:
        # both kinds of covered hit occurred: dropped, and kept unblocked
        assert int(sc_t[2]) > 0
        assert (da_t.numpy() != da0).any()


@pytest.mark.parametrize("recover", [False, True], ids=["simple", "recover"])
def test_hit_launch_outputs_unchanged_by_int32_walk_inputs(recover,
                                                          monkeypatch):
    """hit_launch hands the chain walk its per-hit arrays in int32 (the
    kernel's type); the same launch with the walk given them in int64,
    as before, has the same outputs and state."""
    from lastz_tpu_torch.ops import resolve_cuda
    s1, s2 = _related_pair(3000, seed=7, ident=0.92, with_n=False)
    seed = parse_seed("11111111111", 28, with_trans=1)
    H = 4096
    pt, state, xors, codes, cum, ends, karr, total = _launch_inputs(
        s1, s2, seed, H)
    de0 = np.full(65536, -1, np.int32)
    de0[::97] = 40
    da0 = np.zeros(65536, np.int32)
    if recover:
        hs = np.arange(7, 65536, 7)
        de0[hs] = np.random.default_rng(5).integers(0, 2500, len(hs))
        da0[hs] = hs
    args = (state["seq1p"], state["seq2p"], state["subsmall_t"].reshape(-1),
            state["csr_pos"], None, cum, ends, karr[:H],
            torch.from_numpy(de0), torch.from_numpy(da0), 0, total, 0,
            int(pt.adj_start), int(pt.step), seed.length, 300, 1 << 30,
            len(s1), len(s2))
    kw = dict(x_drop=300, no_extend=False, self_compare=False,
              same_strand=False, use_thresh=True, has_alive=False, K=16,
              nprobe=len(xors), H=H, out_cap=512, recover=recover)
    own = resolve_cuda.resolve_chains
    seen = []

    def int64_walk(*a, **k):
        seen.append({t.dtype for t in a[2:4]})
        return own(*(t.long() if t.dtype == torch.int32 and i in (2, 3)
                     else t for i, t in enumerate(a)),
                   **{n: t.long() if n == "diag_s" else t
                      for n, t in k.items()})

    got = th.hit_launch(*args, **kw)
    monkeypatch.setattr(resolve_cuda, "resolve_chains", int64_walk)
    want = th.hit_launch(*args, **kw)
    assert seen == [{torch.int32}]
    assert int(got[3][0]) > 20 and int(got[3][4]) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _port_engine_inputs(s1, seed_str, trans, gf_extend, thresh, x_drop,
                        bits=28):
    """The port's seed, table and hit parameters (its own classes)."""
    seed = t_parse_seed(seed_str, bits, with_trans=trans)
    pt = t_build_table(s1, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    hp = THitParams(gf_extend=gf_extend, scoring=t_score_set(),
                    x_drop=x_drop,
                    hsp_threshold=tconfig.ScoreThreshold("S", thresh))
    return seed, pt, hp


def _port_hits(s1, s2, seed_str, trans, gf_extend, thresh, x_drop=910,
               bits=28, **kw):
    seed, pt, hp = _port_engine_inputs(s1, seed_str, trans, gf_extend,
                                       thresh, x_drop, bits)
    hits = []
    eng = SeedSearchEngine(
        s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
        lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln,
        device=CPU, **kw)
    runs = device_hits.device_search.runs
    st = tstats.reset()
    eng.search(0, len(s2))
    assert device_hits.device_search.runs == runs + 1  # not the host path
    assert "seed host searches" not in st.extra
    return hits


JAX_DEVICE = {"LASTZ_TPU_SCALAR_SEARCH": "0", "LASTZ_TPU_HITGEN": "1",
              "LASTZ_TPU_HIT_BUDGET": str(1 << 15)}


def _collision_pair():
    """tests/test_hitgen.py:177-205: a segment repeated at a distance of
    exactly 65536, so every query word hits two true diagonals with one
    hashed diagonal."""
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    core = alpha[rng.integers(0, 4, 3000)]
    fill = alpha[rng.integers(0, 4, 65536 - 3000)]
    s1 = np.concatenate([core, fill, core, alpha[rng.integers(0, 4, 500)]])
    s2 = core.copy()
    mut = rng.random(len(s2)) < 0.10
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    return s1, s2


# name: (pair, seed, max index bits, trans, gf_extend, thresh, x_drop,
# hit mode); a pair is _related_pair's arguments or a function
SEARCH_CASES = {
    "trans0": ((6000,), "1110100110010101111", 28, 0, GFEX_XDROP, 3000, 910,
               "simple"),
    "trans1": ((6000,), "1110100110010101111", 28, 1, GFEX_XDROP, 3000, 910,
               "simple"),
    "trans2": ((6000,), "1110100110010101111", 28, 2, GFEX_XDROP, 3000, 910,
               "simple"),
    "dense_chains": ((3000, 7, 0.92), "11111111", 28, 0, GFEX_XDROP, 300,
                     300, "simple"),
    "no_extend": ((2500, 5), "111111111111", 28, 0, GFEX_NO_EXTEND, 0, 910,
                  "simple"),
    "halfweight": ((4000, 13), "TTT0T0TTT0TT0TTTT", 28, 0, GFEX_XDROP, 2000,
                   910, "simple"),
    "recover_trans0": ((6000,), "1110100110010101111", 28, 0, GFEX_XDROP,
                       3000, 910, "recover"),
    "recover_trans1": ((6000,), "1110100110010101111", 28, 1, GFEX_XDROP,
                       3000, 910, "recover"),
    "recover_trans2": ((6000,), "1110100110010101111", 28, 2, GFEX_XDROP,
                       3000, 910, "recover"),
    "recover_collisions": (_collision_pair, "1110100110010101111", 28, 0,
                           GFEX_XDROP, 2000, 910, "recover"),
    "overweight": ((6000, 4, 0.97), "111011011010111", 16, 1, GFEX_XDROP,
                   1000, 910, "simple"),
    "overweight_dense": ((4000, 17, 0.95), "1111011111", 12, 1, GFEX_XDROP,
                         300, 300, "simple"),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_device_search_matches_scalar_and_jax(case):
    pair, pattern, bits, trans, gfex, thresh, x_drop, mode = \
        SEARCH_CASES[case]
    s1, s2 = pair() if callable(pair) else _related_pair(*pair)
    if bits == 28:
        args = (s1, s2, pattern, trans, gfex, thresh)
        ref = _collect(*args, x_drop=x_drop, env=SCALAR, hit_mode=mode)
        dev = _collect(*args, x_drop=x_drop, env=JAX_DEVICE, hit_mode=mode)
    else:
        seed = parse_seed(pattern, bits, with_trans=trans)
        assert seed.type == "R" and len(seed.resolve_bits) > 0
        ref = _collect_seed(s1, s2, seed, SCALAR, gfex, thresh, x_drop)
        dev = _collect_seed(s1, s2, seed, JAX_DEVICE, gfex, thresh, x_drop)
    got = _port_hits(s1, s2, pattern, trans, gfex, thresh, x_drop=x_drop,
                     bits=bits, hit_mode=mode)
    assert len(ref) > 0
    assert dev == ref
    assert got == ref
    if case == "recover_collisions":  # collisions were recovered
        simple = _collect(s1, s2, pattern, trans, gfex, thresh, env=SCALAR)
        assert len(ref) > len(simple)


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
    """Twins are outside the device search: the port's engine hands
    them to its own host engines and counts it."""
    L = 19
    spans = (2 * L, 2 * L + 25)
    s1, s2 = _related_pair(6000, seed=4, ident=0.97)
    args = (s1, s2, "1110100110010101111", 1, GFEX_XDROP, 3000)
    ref = _collect(*args, env=SCALAR, twin_spans=spans)
    seed, pt, hp = _port_engine_inputs(s1, args[2], 1, tconfig.GFEX_XDROP,
                                       3000, 910)
    hits = []
    eng = SeedSearchEngine(
        s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
        lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln,
        hit_mode="twin", twin_min_span=spans[0], twin_max_span=spans[1],
        device=CPU)
    st = tstats.reset()
    runs = device_hits.device_search.runs
    eng.search(0, len(s2))
    assert device_hits.device_search.runs == runs
    assert st.extra.get("seed host searches") == 1
    assert hits == ref and len(ref) > 0


def _gapped_blocks_pair(parts=4, n=1000, seed=21):
    """A query of `parts` pieces of n bp against a target holding each
    piece twice, 65536 bp apart, so that both copies' diagonals share
    one hash (a hash of its own for each piece): the first copy whole,
    the second cut every 300 bp by 15 transversions (its hits come
    first at each query position).  A hit on the whole copy just past
    a cut extends left across the extent that the cut copy's block left
    on the hash (a bind row), and the block cuts that extension short.
    (AC)n and A-rich low-complexity stretches give scores that entropy
    lowers."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    x = alpha[rng.integers(0, 4, parts * n)]
    for lo in range(150, parts * n - 600, 900):
        x[lo: lo + 60] = np.frombuffer(b"AC" * 30, dtype=np.uint8)
        x[lo + 450: lo + 530] = np.where(rng.random(80) < 0.8, ord("A"),
                                         ord("T"))
    cut = x.copy()
    for lo in range(300, parts * n, 300):
        # transversions (A->C, C->G, G->T, T->A)
        cut[lo: lo + 15] = alpha[(np.searchsorted(alpha, x[lo: lo + 15])
                                  + 1) % 4]
    s1 = alpha[rng.integers(0, 4, 65536 + parts * (n + 100) + 500)]
    for i in range(parts):
        at = i * (n + 100)
        s1[at: at + n] = x[i * n: (i + 1) * n]
        s1[65536 + at: 65536 + at + n] = cut[i * n: (i + 1) * n]
    s2 = x.copy()
    mut = rng.random(len(s2)) < 0.04
    s2[mut] = alpha[rng.integers(0, 4, int(mut.sum()))]
    return s1, s2


def _anchor_search(s1, s2, loop, many=True, gf_extend=tconfig.GFEX_XDROP,
                   thresh=("S", 3000), entropic=True, search_limit=0):
    """The port's device search (on the CPU) into an anchors table, as
    the pipeline's anchors-mode reporter fills it, with its bulk form
    where `many`.  `loop` takes the engine's native scans away, which
    keeps the per-candidate loop.  Returns the table's rows (pos1,
    pos2, length, score, seg_id, hsp_id) in order, bases_hit,
    search_to_go and the replay counters."""
    from lastz_tpu_torch.align.segments import SegmentTable
    seed, pt, hp = _port_engine_inputs(s1, "1110100110010101111", 1,
                                       gf_extend, 0, 910)
    hp.hsp_threshold = tconfig.ScoreThreshold(*thresh)
    hp.entropic_hsp = entropic
    anchors = SegmentTable(coverage_limit=thresh[1] if thresh[0] == "C"
                           else 0)

    def reporter(pos1, pos2, length, s):
        anchors.add(pos1 - length, pos2 - length, length, s, 1)
        return length

    if many:
        def bulk(pos1, pos2, length, s):
            anchors.add_many(pos1 - length, pos2 - length, length, s, 1)
            return length
        reporter.many = bulk
    eng = SeedSearchEngine(s1, pt, s2, seed, UPPER_NUC_TO_BITS, hp,
                           reporter, device=CPU, anchors=anchors,
                           search_limit=search_limit)
    if loop:
        eng._native = None
    SegmentTable._hsp_id_counter = 5000
    st = tstats.reset()
    bases = eng.search(0, len(s2))
    rows = [(g.pos1, g.pos2, g.length, g.score, g.seg_id, g.hsp_id)
            for g in anchors]
    return rows, bases, eng.search_to_go, _replay_counts(st)


REPLAY_COUNTERS = ("replay candidates", "replay bulk candidates",
                   "replay bind re-extensions", "replay entropy rows")


def _replay_counts(st):
    return {k: st.extra.get(k, 0) for k in REPLAY_COUNTERS}


def _report_mode_run(s1, s2, tmp_path, monkeypatch, capsys, loop):
    """The port's CLI with --nogapped on the CPU device, whose pipeline
    prints each anchor as it comes (report mode: a reporter with no
    bulk form); `loop` as in _anchor_search.  Returns the output, bases
    (None) and search_to_go (None) in _anchor_search's places, and the
    replay counters."""
    from lastz_tpu_torch import cli
    from lastz_tpu_torch.pipeline import Pipeline
    paths = []
    for name, v in (("t", s1), ("q", s2)):
        path = tmp_path / f"{name}.fa"
        path.write_bytes(b">" + name.encode() + b"\n" + v.tobytes() + b"\n")
        paths.append(str(path))
    modes = []
    with monkeypatch.context() as m:
        m.setenv("LASTZ_TORCH_DEVICE", "cpu")
        m.delenv("LASTZ_TPU_DEVICE", raising=False)
        uncached = Pipeline._reporter_mode_uncached
        m.setattr(Pipeline, "_reporter_mode_uncached",
                  lambda self: modes.append(uncached(self)) or modes[-1])
        if loop:
            init = SeedSearchEngine.__init__

            def init_without_native(self, *a, **kw):
                init(self, *a, **kw)
                self._native = None
            m.setattr(SeedSearchEngine, "__init__", init_without_native)
        capsys.readouterr()
        assert cli.main(paths + ["--nogapped"]) == 0
    assert modes == ["report"]
    return capsys.readouterr().out, None, None, _replay_counts(tstats.current)


# name: (_anchor_search keywords, OUT_CAP, whether the array replay runs)
REPLAY_CASES = {
    "entropy": (dict(), None, True),
    "bind_rows": (dict(thresh=("S", 2000)), None, True),
    "out_cap_split": (dict(thresh=("S", 2000)), 64, True),
    "report_mode": (None, None, True),
    "coverage_threshold": (dict(thresh=("C", 4000)), None, False),
    "search_limit": (dict(search_limit=10 ** 6), None, False),
    "no_extend": (dict(gf_extend=tconfig.GFEX_NO_EXTEND,
                       thresh=("S", 0)), None, False),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_array_replay_matches_the_loop(case, tmp_path, monkeypatch, capsys):
    """The array replay of the device's survivors (score, entropy,
    threshold, bind rows re-extended at once, the kept rows reported in
    order) fills the anchors table as the per-candidate loop does: the
    same rows, scores and hsp_ids in order, bases_hit and search_to_go,
    through the reporter's bulk form and through one call a row; and
    the pipeline's report mode prints the same matches.  Where a
    configuration keeps the loop, no row takes the array replay."""
    kw, out_cap, arrays = REPLAY_CASES[case]
    s1, s2 = _gapped_blocks_pair()
    if out_cap is not None:
        monkeypatch.setattr(device_hits, "OUT_CAP", out_cap)
    if kw is None:
        def search(loop):
            return _report_mode_run(s1, s2, tmp_path, monkeypatch, capsys,
                                    loop)
    else:
        def search(loop, **more):
            return _anchor_search(s1, s2, loop, **kw, **more)
    loop = search(loop=True)
    got = search(loop=False)
    assert got[:3] == loop[:3]
    assert len(loop[0]) > 0
    counts = got[3]
    assert counts["replay candidates"] > 0
    assert loop[3]["replay bulk candidates"] == 0
    if not arrays:
        assert counts["replay bulk candidates"] == 0
        return
    assert counts["replay bulk candidates"] == counts["replay candidates"]
    if case == "entropy":
        # low-complexity stretches push candidates under K
        assert counts["replay entropy rows"] > 0
        assert search(loop=False, many=False)[:3] == loop[:3]
        plain = search(loop=False, entropic=False)
        assert plain[0] != got[0]
    elif case == "report_mode":
        # each match printed as an ungapped LAV block
        assert loop[0].count("\na {") > 1
    else:
        assert counts["replay bind re-extensions"] > 0
        assert counts["replay bind re-extensions"] < counts[
            "replay candidates"]
    if out_cap is not None:
        assert counts["replay candidates"] > out_cap
