"""The port's gapped stage (lastz_tpu_torch/ops/ydrop_exact.py and
ops/ydrop_cuda.py) against lastz_tpu's: the plain PyTorch chunk equals
the JAX chunk and the Pallas kernel (interpret mode) state for state
and traceback byte for byte, the mega loop plus traceback equal
ydrop_mega plus traceback_mega_dev, and the mega loop run one lane at
a time (as the mega kernel's warps run it) equals both.  Inputs come
from a numpy seed; the tolerance is exact equality (integer DP state
and link bytes)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lastz_tpu.core.scoring import new_dna_score_set
from lastz_tpu.ops import ydrop_exact as jx
from lastz_tpu.ops.ydrop_pallas_exact import ydrop_chunk_pallas
from lastz_tpu_torch.ops import ydrop_exact as tx
from lastz_tpu_torch.ops.ydrop_cuda import (traceback_mega, ydrop_chunk,
                                            ydrop_mega)

from chip_smoke import WALK_EDGE_CAPS, walk_inputs
from test_torch_cuda import _mega_inputs

CASES = {
    # name: (B, rows, W, y_drop, div, trim_to_peak, tb_cap, chunks, seed)
    # -- the five cases of tests/test_ydrop_pallas_exact.py:96-116
    "basic": (8, 96, 256, 3000, 0.12, True, 1 << 20, 1, 1),
    "multi_chunk_resume": (8, 64, 384, 4000, 0.08, True, 1 << 20, 3, 2),
    "boundary_noytrim": (8, 80, 256, 3000, 0.10, False, 1 << 20, 1, 3),
    "truncation": (8, 96, 256, 3000, 0.10, True, 600, 1, 4),
    "high_divergence": (8, 96, 256, 900, 0.45, True, 1 << 20, 1, 5),
    # -- the main path's y-drop: bands past 416 columns, over several of
    # K1's 288-column tiles (csrc/ydrop_chunk.cu)
    "wide_band": (4, 160, 768, 9400, 0.20, True, 1 << 24, 1, 6),
}


def _pair(rng, n, div):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < div
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    return s1, s2


def _windows(state_np, prev_off, a_full, b_full, rows, W):
    """Host-side windows of the next chunk (the JAX test's recipe)."""
    B = a_full.shape[0]
    done = state_np["done"]
    row_base = state_np["row"].astype(np.int64) - 1
    b_off = np.where(done, prev_off, state_np["LY"].astype(np.int64))
    shift = (b_off - prev_off).astype(np.int32)
    a_win = np.zeros((B, rows), np.int32)
    b_win = np.zeros((B, W), np.int32)
    for b in range(B):
        lo = int(row_base[b])
        src = a_full[b, lo: lo + rows]
        a_win[b, : len(src)] = src
        lo2 = int(b_off[b])
        if lo2 == 0:
            src = b_full[b, : W - 1]
            b_win[b, 1: 1 + len(src)] = src
        else:
            src = b_full[b, lo2 - 1: lo2 - 1 + W]
            b_win[b, : len(src)] = src
    return a_win, b_win, b_off, shift


def _assert_state_equal(st_ref, st_port, what):
    for k in jx.STATE_KEYS:
        a = np.asarray(st_ref[k])
        b = st_port[k].cpu().numpy()
        assert a.dtype == b.dtype, f"{what}: state[{k}] dtype"
        assert np.array_equal(a, b), f"{what}: state[{k}] differs"


def _case_inputs(case):
    """A CASES entry's sequences (compact codes, per lane), M, N, the
    chunk keywords and the fresh state, checked against the JAX
    package's helpers."""
    B, rows, W, y_drop, div, trim, tb_cap, chunks, seed = CASES[case]
    rng = np.random.default_rng(seed)
    sc = new_dna_score_set()
    ge = int(sc.gap_extend)
    goe = int(sc.gap_open + sc.gap_extend)
    s1, s2 = _pair(rng, rows * (chunks + 1) + W + 64, div)
    code_map, subsmall = tx.make_compact_alphabet([s1, s2], sc.sub)
    ref_map, ref_sub = jx.make_compact_alphabet([s1, s2], sc.sub)
    assert np.array_equal(code_map, ref_map)
    assert np.array_equal(subsmall, ref_sub)
    a_full = np.stack([code_map[s1[o:o + rows * chunks + 8]]
                       for o in rng.integers(0, 32, B)])
    b_full = np.stack([code_map[s2[o:o + rows * chunks + W + 8]]
                       for o in rng.integers(0, 32, B)])
    Ms = np.full(B, a_full.shape[1] - 2, np.int32)
    Ns = np.full(B, b_full.shape[1] - 2, np.int32)
    kw = dict(gap_e=ge, gap_oe=goe, y_drop=y_drop, lanes=W, rows=rows,
              alpha=subsmall.shape[0], trim_to_peak=trim, tb_cap=tb_cap)
    st_np, _ = tx.fresh_state_np(Ns.astype(np.int64), ge, goe, y_drop, W, B)
    ref_np, _ = jx.fresh_state_np(Ns.astype(np.int64), ge, goe, y_drop, W,
                                  B)
    for k in st_np:
        assert np.array_equal(st_np[k], ref_np[k])
    return a_full, b_full, Ms, Ns, subsmall, kw, st_np


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_matches_jax_and_pallas(case):
    B, rows, W = CASES[case][:3]
    chunks = CASES[case][7]
    a_full, b_full, Ms, Ns, subsmall, kw, st_np = _case_inputs(case)
    st_j = {k: jnp.asarray(v) for k, v in st_np.items()}
    st_p = {k: jnp.asarray(v) for k, v in st_np.items()}
    st_t = {k: torch.from_numpy(v) for k, v in st_np.items()}
    prev_off = np.zeros(B, np.int64)
    for chunk in range(chunks):
        a_win, b_win, b_off, shift = _windows(
            {k: np.asarray(v) for k, v in st_j.items()}, prev_off,
            a_full, b_full, rows, W)
        prev_off = b_off
        args_np = (a_win, b_win, b_off.astype(np.int32), shift, Ms, Ns)
        st_j, tb_j = jx.ydrop_chunk(*map(jnp.asarray, args_np), st_j,
                                    jnp.asarray(subsmall), **kw)
        st_p, tb_p = ydrop_chunk_pallas(*map(jnp.asarray, args_np), st_p,
                                        jnp.asarray(subsmall), G=min(B, 8),
                                        interpret=True, **kw)
        launched = ydrop_chunk.launches
        st_t, tb_t = ydrop_chunk(*map(torch.from_numpy, args_np), st_t,
                                 torch.from_numpy(subsmall), **kw)
        assert ydrop_chunk.launches == launched  # CPU: the plain version
        _assert_state_equal(st_j, st_t, f"{case} chunk {chunk} vs XLA")
        _assert_state_equal(st_p, st_t, f"{case} chunk {chunk} vs Pallas")
        assert np.array_equal(np.asarray(tb_j), tb_t.numpy())
        assert np.array_equal(np.asarray(tb_p), tb_t.numpy())
        if np.asarray(st_j["done"]).all():
            break


@pytest.mark.parametrize("case", list(CASES))
def test_rows_write_only_their_band(case):
    """The invariant the band-only K1 relies on, row by row: a row that
    runs leaves every link byte zero, and sets CC/DD to NEG, outside
    [LYr, max(RYr + p, sentinel + 1)).  One row per call (rows=1,
    shift=0, b_off=0), so each call's input and output state give LYr,
    RYr, p and the sentinel; the last call is held against JAX's
    ydrop_chunk on the same numpy inputs."""
    B, rows, W = CASES[case][:3]
    total = rows * CASES[case][7]
    a_full, b_full, Ms, Ns, subsmall, kw, st_np = _case_inputs(case)
    kw = dict(kw, rows=1)
    b_win = np.zeros((B, W), np.int32)
    b_win[:, 1:] = b_full[:, : W - 1]
    zero = np.zeros(B, np.int32)
    st = {k: torch.from_numpy(v) for k, v in st_np.items()}
    widest = 0
    for _ in range(total):
        # a lane whose band left the window would need a re-anchor
        st["done"] = st["done"] | (st["RY"] > W)
        if bool(st["done"].all()):
            break
        row_base = st["row"].numpy().astype(np.int64) - 1
        a_win = a_full[np.arange(B), np.minimum(row_base, a_full.shape[1] - 1)]
        args_np = (a_win[:, None].astype(np.int32), b_win, zero, zero, Ms, Ns)
        st_in = st
        st, tb = tx.ydrop_chunk_plain(*map(torch.from_numpy, args_np), st_in,
                                      torch.from_numpy(subsmall), **kw)
        for b in np.nonzero((st["row"] != st_in["row"]).numpy())[0]:
            LYr, RYr, RYo = (int(st_in["LY"][b]), int(st_in["RY"][b]),
                             int(st["RY"][b]))
            p = int(st["tbp"][b] - st_in["tbp"][b]) - (RYr - LYr)
            assert RYo <= Ns[b]  # so the row wrote a sentinel at RYo - 1
            lo = max(min(LYr, RYr), 0)
            hi = min(max(RYr + p, RYo), W)
            out = np.ones(W, bool)
            out[lo:hi] = False
            assert not tb[b, 1].numpy()[out].any()
            assert (st["CC"][b].numpy()[out] == tx.NEG).all()
            assert (st["DD"][b].numpy()[out] == tx.NEG).all()
            widest = max(widest, hi - lo)
    assert not tb[:, 0].any()
    st_j, tb_j = jx.ydrop_chunk(*map(jnp.asarray, args_np),
                                {k: jnp.asarray(v.numpy())
                                 for k, v in st_in.items()},
                                jnp.asarray(subsmall), **kw)
    _assert_state_equal(st_j, st, f"{case} last row vs XLA")
    assert np.array_equal(np.asarray(tb_j), tb.numpy())
    if case == "wide_band":
        assert widest > 416


def test_mega_and_traceback_match_jax():
    seqs, lane, st_np, subsmall, kw = _mega_inputs()
    B2 = lane[0].shape[0]
    j = jx.ydrop_mega(*map(jnp.asarray, seqs + lane),
                      {k: jnp.asarray(v) for k, v in st_np.items()},
                      jnp.zeros(B2, jnp.int32), jnp.asarray(subsmall), **kw)
    t = ydrop_mega(*map(torch.from_numpy, seqs + lane),
                      {k: torch.from_numpy(v) for k, v in st_np.items()},
                      torch.zeros(B2, dtype=torch.int32),
                      torch.from_numpy(subsmall), **kw)
    st_j, prev_j, packed_j, tb_j, lo_j, hi_j, c0_j = j
    st_t, prev_t, packed_t, tb_t, lo_t, hi_t, c0_t = t
    _assert_state_equal(st_j, st_t, "mega")
    for name, a, b in (("prev_off", prev_j, prev_t),
                       ("packed", packed_j, packed_t), ("tb_all", tb_j, tb_t),
                       ("row_lo", lo_j, lo_t), ("row_hi", hi_j, hi_t),
                       ("col0", c0_j, c0_t)):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    done = st_t["done"].numpy()
    assert done.any() and not done.all()  # both kinds of lane exercised
    cap = kw["max_blocks"] * kw["rows"] + kw["lanes"] + 512
    ref = jx.traceback_mega_dev(tb_j, lo_j, hi_j, c0_j, packed_j[12],
                                st_j["end1"], st_j["end2"],
                                jnp.asarray(done), cap=cap)
    got = traceback_mega(tb_t, lo_t, hi_t, c0_t, packed_t[12],
                         st_t["end1"], st_t["end2"],
                         torch.from_numpy(done), cap)
    for name, a, b in zip(("ops", "n", "row", "col"), ref, got):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    # a short cap cuts every walk exactly where the lockstep loop does
    ref = jx.traceback_mega_dev(tb_j, lo_j, hi_j, c0_j, packed_j[12],
                                st_j["end1"], st_j["end2"],
                                jnp.asarray(done), cap=40)
    got = traceback_mega(tb_t, lo_t, hi_t, c0_t, packed_t[12],
                         st_t["end1"], st_t["end2"],
                         torch.from_numpy(done), 40)
    for name, a, b in zip(("ops", "n", "row", "col"), ref, got):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    # the score-only continuation of the unfinished lanes
    sel = np.nonzero(~done)[0]
    sel_t = torch.from_numpy(sel)
    c_lane = tuple(a[sel] for a in lane)
    j2 = jx.ydrop_mega(*map(jnp.asarray, seqs + c_lane),
                       {k: v[sel] for k, v in st_j.items()}, prev_j[sel],
                       jnp.asarray(subsmall), with_tb=False, **kw)
    t2 = ydrop_mega(*map(torch.from_numpy, seqs + c_lane),
                       {k: v[sel_t] for k, v in st_t.items()},
                       prev_t[sel_t], torch.from_numpy(subsmall),
                       with_tb=False, **kw)
    _assert_state_equal(j2[0], t2[0], "continuation")
    for name, i in (("prev_off", 1), ("packed", 2), ("row_lo", 4)):
        assert np.array_equal(np.asarray(j2[i]), t2[i].numpy()), name


# target positions of six anchors on _mega_inputs' 1500 bp pair: with
# 64-row chunks and 4 blocks, lanes that end after one chunk (39 and 31
# rows), after several (79, 151 and 199 rows) and after none of the
# four (the rest)
MIXED_ANCHORS = [30, 150, 700, 1300, 1420, 1460]


@pytest.mark.parametrize("with_tb", [True, False], ids=["links", "scores"])
def test_mega_lanes_plain_matches_jax_and_lockstep(with_tb):
    """ydrop_mega_lanes_plain (each lane alone, to its own end), the
    lockstep ydrop_mega_plain and the ydrop_mega wrapper on CPU tensors
    all equal lastz_tpu's ydrop_mega, output for output."""
    seqs, lane, st_np, subsmall, kw = _mega_inputs(anchors=MIXED_ANCHORS)
    B2 = lane[0].shape[0]
    ref = jx.ydrop_mega(*map(jnp.asarray, seqs + lane),
                        {k: jnp.asarray(v) for k, v in st_np.items()},
                        jnp.zeros(B2, jnp.int32), jnp.asarray(subsmall),
                        with_tb=with_tb, **kw)
    args = (*map(torch.from_numpy, seqs + lane),
            {k: torch.from_numpy(v) for k, v in st_np.items()},
            torch.zeros(B2, dtype=torch.int32), torch.from_numpy(subsmall))
    names = ("prev_off", "packed", "tb_all", "row_lo", "row_hi", "col0")
    for fn in (tx.ydrop_mega_lanes_plain, tx.ydrop_mega_plain, ydrop_mega):
        got = fn(*args, with_tb=with_tb, **kw)
        _assert_state_equal(ref[0], got[0], fn.__name__)
        for name, a, b in zip(names, ref[1:], got[1:]):
            assert np.asarray(a).dtype == b.numpy().dtype, name
            assert np.array_equal(np.asarray(a), b.numpy()), \
                f"{fn.__name__}: {name}"
    nblk = got[2][12].numpy()
    done = got[0]["done"].numpy()
    assert (done & (nblk == 1)).any() and (done & (nblk > 1)).any()
    assert (~done & (nblk == kw["max_blocks"])).any()
    if not with_tb:
        assert tuple(got[3].shape) == (B2, 1, 1, 1)


@pytest.mark.parametrize("cap", WALK_EDGE_CAPS)
def test_walk_matches_jax_on_synthetic_blocks(cap):
    """The walk against traceback_mega_dev on random link bytes
    (chip_smoke.walk_inputs), at caps on the edges of the CUDA kernel's
    8-step groups and 64-row tiles and to the end of every walk
    (None)."""
    arrays = walk_inputs()
    K, R1, W = arrays[0].shape[1:]
    full = cap is None
    cap = cap or K * R1 + W + 512
    ref = jx.traceback_mega_dev(*map(jnp.asarray, arrays), cap=cap)
    got = traceback_mega(*map(torch.from_numpy, arrays), cap)
    for name, a, b in zip(("ops", "n", "row", "col"), ref, got):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    n, row, col = (a.numpy() for a in got[1:])
    assert n[0] == 0 and row[0] == 0 and col[0] == 0  # not wanted
    if full:
        # lane 1 walked through every block to its start; some lane
        # went past column 0 (where a clamped cell that keeps sending it
        # left holds it until the cap); lane 3 ran along row 0
        assert row[1] <= 0 and col[1] <= 0 and n[1] > 3 * (R1 - 1)
        assert (col < 0).any()
        ops3 = got[0][3].numpy()
        assert row[3] == 0 and (ops3[n[3] - 5: n[3]] == tx.OP_I).all()


# (name, _mega_inputs keywords): MIXED_ANCHORS' lanes in 64-row chunks,
# and lanes at the main path's y-drop (9400) whose bands grow past K1's
# narrow tile (160 columns) over several of its 288-column tiles
CENSUS_CASES = {
    "mixed": dict(anchors=MIXED_ANCHORS),
    "wide": dict(seed=5, n=3000, Bh=2, W=1536, y_drop=9400, rows=128,
                 max_blocks=2),
}


@pytest.mark.parametrize("case", list(CENSUS_CASES))
def test_band_census_matches_a_row_by_row_count(case):
    """band_census over the widths that ydrop_mega_plain records row by
    row (bands=) equals a direct count: ydrop_mega_lanes_plain stepped
    one row a call from the same state, RY - LY read before each row
    that ran.  Each lane's recorded rows are the first rows of the
    stepped run, as many as lane_rows reads from the launch's outputs,
    and a lane that finished in the launch ran no more."""
    seqs, lane, st_np, subsmall, kw = _mega_inputs(**CENSUS_CASES[case])
    B = lane[0].shape[0]
    seq_t = tuple(map(torch.from_numpy, seqs + lane))
    state = {k: torch.from_numpy(v) for k, v in st_np.items()}
    sub = torch.from_numpy(subsmall)
    bands = []
    out = tx.ydrop_mega_plain(*seq_t, state, torch.zeros(B, dtype=torch.int32),
                              sub, bands=bands, **kw)
    widths = tx.lane_bands(bands)
    rows = tx.lane_rows(out[2][12].numpy(), out[4].numpy(), out[5].numpy())
    assert [len(w) for w in widths] == rows.tolist()
    census = tx.band_census(widths)
    assert census["lane_rows"] == rows.tolist()

    one = dict(kw, rows=1, max_blocks=1)
    st, prev = state, torch.zeros(B, dtype=torch.int32)
    direct = [[] for _ in range(B)]
    for _ in range(int(rows.max()) + 1):
        got = tx.ydrop_mega_lanes_plain(*seq_t, st, prev, sub, **one)
        for b in torch.nonzero(got[0]["row"] != st["row"])[:, 0].tolist():
            direct[b].append(int(st["RY"][b]) - int(st["LY"][b]))
        st, prev = got[0], got[1]
    done = out[0]["done"].numpy()
    for b in range(B):
        assert direct[b][:rows[b]] == widths[b].tolist(), b
        if done[b]:
            assert len(direct[b]) == rows[b], b
    want = tx.band_census([np.array(d[:r], np.int64)
                           for d, r in zip(direct, rows)])
    assert want == census
    tiles = tx.row_tiles(np.concatenate(widths))
    assert census["all"]["tiles_max"] == int(tiles.max())
    assert census["all"]["rows"] == int(rows.sum())
    if case == "wide":
        assert census["all"]["tiles_max"] >= 2
    else:
        assert done.any() and not done.all()
