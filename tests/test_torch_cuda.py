"""The port's CUDA kernels against their plain PyTorch versions on a
card.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest -m cuda tests/test_torch_cuda.py

Each test skips where torch finds no card (a CUDA kernel has no CPU
mode).  The tolerance is exact equality: integer DP state, link bytes,
x-drop results (K2 and its wide instantiation), the (best, row, column)
of K3 and K3b, the chain walk's outputs and the device-built position
table."""

import numpy as np
import pytest
import torch

from lastz_tpu_torch.core.scoring import new_dna_score_set
from lastz_tpu_torch.device import carry_state
from lastz_tpu_torch.ops import ydrop_exact as tx
from lastz_tpu_torch.ops import ydrop_pallas as tp
from lastz_tpu_torch.ops.xdrop_cuda import xdrop_scan
from lastz_tpu_torch.ops.ydrop_cuda import (traceback_mega, ydrop_chunk,
                                            ydrop_mega)

from chip_smoke import (CHAIN_EDGES, WALK_EDGE_CAPS, WALK_EDGE_GEOMETRY,
                        XDROP_EDGES, chain_edge_inputs, chain_walk_args,
                        cut_codes, walk_inputs, xdrop_edge_inputs)
from test_hitgen import _related_pair
import torch_threads  # noqa: F401  (a share of the cores per xdist worker)


def _mega_inputs(seed=21, n=1500, Bh=6, W=256, y_drop=3000, rows=64,
                 max_blocks=4, anchors=None):
    """One small mega launch: Bh anchors near the diagonal of a related
    pair (at target positions `anchors` when given), both directions,
    64-row chunks, 4 retained blocks (so some lanes finish inside the
    blocks and some do not)."""
    rng = np.random.default_rng(seed)
    sc = new_dna_score_set()
    alpha = np.frombuffer(b"ACGT", np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < 0.12
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    code_map, subsmall = tx.make_compact_alphabet([s1, s2], sc.sub)
    a1 = rng.integers(50, n - 50, Bh)
    if anchors is not None:
        a1 = np.asarray(anchors)
        Bh = len(a1)
    a2 = np.clip(a1 + rng.integers(-3, 4, Bh), 0, n - 1)
    A1 = np.concatenate([a1, a1]).astype(np.int32)
    A2 = np.concatenate([a2, a2]).astype(np.int32)
    REV = np.arange(2 * Bh) >= Bh
    lo = np.zeros(2 * Bh, np.int32)
    hi = np.full(2 * Bh, n, np.int32)
    M = np.where(REV, A1 + 1, n - (A1 + 1)).astype(np.int32)
    N = np.where(REV, A2 + 1, n - (A2 + 1)).astype(np.int32)
    ge = int(sc.gap_extend)
    goe = int(sc.gap_open + sc.gap_extend)
    st_np, _ = tx.fresh_state_np(N.astype(np.int64), ge, goe, y_drop, W,
                                 2 * Bh)
    seqs = (code_map[s1].astype(np.int8), code_map[s2].astype(np.int8))
    lane = (A1, A2, lo, hi, lo, hi, REV, M, N)
    kw = dict(gap_e=ge, gap_oe=goe, y_drop=y_drop, lanes=W, rows=rows,
              max_blocks=max_blocks, alpha=16, trim_to_peak=True,
              tb_cap=80 * 1024 * 1024)
    return seqs, lane, st_np, subsmall, kw


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _mega(dev, seqs, lane, state, prev, subsmall, kw, with_tb=True):
    def up(a):
        if torch.is_tensor(a):
            return a.to(dev)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return ydrop_mega(*map(up, seqs + lane),
                      {k: up(v) for k, v in state.items()}, up(prev),
                      up(subsmall), with_tb=with_tb, **kw)


@pytest.mark.cuda
def test_cuda_ydrop_matches_plain():
    """K1's mega launch, with and without link bytes, and the traceback
    kernel, each against its plain version."""
    dev = _card()
    seqs, lane, st_np, subsmall, kw = _mega_inputs()
    prev0 = np.zeros(lane[0].shape[0], np.int32)
    n0 = ydrop_mega.launches
    got = _mega(dev, seqs, lane, st_np, prev0, subsmall, kw)
    assert ydrop_mega.launches == n0 + 1
    want = _mega(torch.device("cpu"), seqs, lane, st_np, prev0, subsmall,
                 kw)
    for k in tx.STATE_KEYS:
        assert torch.equal(got[0][k].cpu(), want[0][k]), k
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)
    st, _, packed, tb, lo, hi, c0 = got
    done = st["done"]
    assert bool(done.any()) and not bool(done.all())
    cap = kw["max_blocks"] * kw["rows"] + kw["lanes"] + 512
    args = (tb, lo, hi, c0, packed[12], st["end1"], st["end2"], done, cap)
    n0 = traceback_mega.launches
    tb_got = traceback_mega(*args)
    assert traceback_mega.launches == n0 + 1
    tb_want = traceback_mega(*(a.cpu() if torch.is_tensor(a) else a
                               for a in args))
    for a, b in zip(tb_got, tb_want):
        assert torch.equal(a.cpu(), b)
    # the score-only continuation of the unfinished lanes
    sel = torch.nonzero(~done)[:, 0].cpu()
    c_lane = tuple(a[sel.numpy()] for a in lane)
    c_state = {k: v[sel.to(v.device)] for k, v in st.items()}
    c_prev = got[1][sel.to(dev)]
    got2 = _mega(dev, seqs, c_lane, c_state, c_prev, subsmall, kw,
                 with_tb=False)
    want2 = _mega(torch.device("cpu"), seqs, c_lane,
                  {k: v.cpu() for k, v in c_state.items()}, c_prev.cpu(),
                  subsmall, kw, with_tb=False)
    for a, b in zip(got2[2:], want2[2:]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_tb", [True, False])
def test_cuda_mega_mixed_lanes(with_tb):
    """The mega launch on lanes that end after one chunk, after several
    and after none of the four, a lane done on entry and lanes resuming
    from a nonzero prev_off, against the plain lockstep loop."""
    dev = _card()
    seqs, lane, st_np, subsmall, kw = _mega_inputs(
        anchors=[30, 150, 700, 1300, 1420, 1460])
    st_np = {k: v.copy() for k, v in st_np.items()}
    st_np["done"][4] = True
    B = lane[0].shape[0]
    got = _mega(dev, seqs, lane, st_np, np.zeros(B, np.int32), subsmall, kw,
                with_tb=with_tb)
    want = _mega(torch.device("cpu"), seqs, lane, st_np,
                 np.zeros(B, np.int32), subsmall, kw, with_tb=with_tb)
    for k in tx.STATE_KEYS:
        assert torch.equal(got[0][k].cpu(), want[0][k]), k
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)
    nblk = want[2][12]
    assert int(nblk[4]) == 0 and int(nblk.max()) == kw["max_blocks"]
    # the unfinished lanes once more, from where they stopped
    again = _mega(dev, seqs, lane, got[0], got[1], subsmall, kw,
                  with_tb=with_tb)
    want2 = _mega(torch.device("cpu"), seqs, lane, want[0], want[1],
                  subsmall, kw, with_tb=with_tb)
    for a, b in zip(again[1:], want2[1:]):
        assert torch.equal(a.cpu(), b)


def _wide_inputs(K, n=30000, H=40000, seed=0):
    """K2's wide instantiation: a related pair of uint8 codes over K
    symbols (a third of it conserved), SEQ_PAD-padded, a K x K table
    with positive matches, and H hits half on the conserved diagonal."""
    from lastz_tpu_torch.device import SEQ_PAD
    rng = np.random.default_rng(seed + K)
    s1 = rng.integers(0, K, n).astype(np.uint8)
    s2 = np.where(rng.random(n) < 0.15, rng.integers(0, K, n), s1)
    s2 = np.where(np.arange(n) % 3000 < 1000, s2,
                  rng.integers(0, K, n)).astype(np.uint8)
    sub = rng.integers(-60, 20, (K, K)).astype(np.int32)
    sub[np.arange(K), np.arange(K)] = rng.integers(40, 100, K)
    pos1 = rng.integers(1, n, H)
    pos2 = np.where(rng.random(H) < 0.5, pos1, rng.integers(1, n, H))
    diag = pos1 - pos2
    n_l = pos1 - np.maximum(diag, 0)
    n_r = np.maximum(np.minimum(n, n + diag) - pos1, 0)
    pad = np.zeros(SEQ_PAD, np.uint8)
    return [torch.from_numpy(a) for a in (
        np.concatenate([pad, s1, pad]), np.concatenate([pad, s2, pad]),
        sub.reshape(-1))], [torch.from_numpy(a.astype(np.int32))
                            for a in (pos1, pos2, n_l, n_r)]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [17, 40, 241, 242, 256])
def test_cuda_xdrop_wide_matches_plain(K):
    """K2's wide instantiation against its plain version: its table in
    shared memory (K <= 241, K x K x 4 bytes within the opt-in 227 KB)
    and through the read-only cache (K > 241)."""
    dev = _card()
    seqs, hits = _wide_inputs(K)
    n0, w0 = xdrop_scan.launches, xdrop_scan.wide_launches
    got = xdrop_scan(*(a.to(dev) for a in seqs), K,
                     *(a.to(dev) for a in hits), 400)
    assert xdrop_scan.launches == n0 + 1
    assert xdrop_scan.wide_launches == w0 + 1
    want = xdrop_scan(*seqs, K, *hits, 400)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)
    assert int(want[1][0].max()) > 256  # walks past stage 1's cells


@pytest.mark.cuda
@pytest.mark.parametrize("case", XDROP_EDGES)
def test_cuda_xdrop_wide_edges(case):
    """The wide instantiation at K2's stage and chunk edges (K = 40)."""
    dev = _card()
    arrays, x_drop, expect = xdrop_edge_inputs(case, 40)
    s1, s2, sub, *rest = (torch.from_numpy(a) for a in arrays)
    got = xdrop_scan(s1.to(dev), s2.to(dev), sub.to(dev), 40,
                     *(a.to(dev) for a in rest), x_drop)
    want = xdrop_scan(s1, s2, sub, 40, *rest, x_drop)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)
    for side in want:
        assert tuple(int(a[0]) for a in side) == expect


@pytest.mark.cuda
@pytest.mark.parametrize("with_tb", [True, False])
@pytest.mark.parametrize("y_drop,min_band", [(9400, 160), (20000, 416)])
def test_cuda_ydrop_wide_band_edges(y_drop, min_band, with_tb):
    """K1's mega launch, one chunk per call, in the main path's window
    (1536): at its y-drop (9400) bands wider than K1's narrow
    tile (5 columns per thread, 160 columns), and at 20000 bands wider
    than 416 columns, past its wide tile (9 per thread, 288), so that a
    row takes several tiles.  The batch holds a lane done on entry, a
    lane truncated before its first row, a lane whose rows end
    mid-chunk (M = 100), a lane whose input CC/DD hold junk right of its
    band (the plain version sets NEG there once a row runs), and lanes
    that resume with shift != 0.  Every chunk's full CC/DD, scalars and
    link bytes equal the plain version's, with and without link
    bytes."""
    dev = _card()
    cpu = torch.device("cpu")
    seqs, lane, st_np, subsmall, kw = _mega_inputs(
        seed=5, n=6000, Bh=3, W=1536, y_drop=y_drop, rows=256, max_blocks=1)
    lane = tuple(a.copy() for a in lane)
    lane[7][2] = 100                       # M: stops mid-chunk
    st_np = {k: v.copy() for k, v in st_np.items()}
    st_np["done"][0] = True                # done on entry
    st_np["tbp"][1] = kw["tb_cap"] - 5     # truncated before its first row
    junk = np.random.default_rng(0).integers(-5000, 5000, 1536)
    right = np.arange(1536) >= st_np["RY"][3]
    st_np["CC"][3] = np.where(right, junk, st_np["CC"][3])
    st_np["DD"][3] = np.where(right, junk - 7, st_np["DD"][3])
    B = lane[0].shape[0]
    st_g = st_c = st_np
    prev_g = prev_c = np.zeros(B, np.int32)
    shifted, band = False, 0
    for _ in range(5):
        got = _mega(dev, seqs, lane, st_g, prev_g, subsmall, kw,
                    with_tb=with_tb)
        want = _mega(cpu, seqs, lane, st_c, prev_c, subsmall, kw,
                     with_tb=with_tb)
        for k in tx.STATE_KEYS:
            assert torch.equal(got[0][k].cpu(), want[0][k]), k
        for name, a, b in zip(("prev_off", "packed", "tb_all", "row_lo",
                               "row_hi", "col0"), got[1:], want[1:]):
            assert torch.equal(a.cpu(), b), name
        shifted |= bool((got[1].cpu() != torch.as_tensor(prev_c)).any())
        band = max(band, int((want[0]["RY"] - want[0]["LY"]).max()))
        st_g, prev_g = got[0], got[1]
        st_c, prev_c = want[0], want[1]
        if bool(st_c["done"].all()):
            break
    assert shifted and band > min_band
    assert int(st_c["rows_used"][0]) == 0
    assert int(st_c["status"][1]) & tx.ST_TRUNCATED
    assert int(st_c["rows_used"][1]) == 0
    assert int(st_c["rows_used"][2]) == 100


def _k1_tiles(width):
    """The tiles K1 sweeps a row of `width` columns in: one of 160
    columns (warp 0 alone) up to 160, else 32 x CPT columns each, CPT
    the least of 3, 5 and 9 whose four tiles (one a warp) cover the
    band, tiles of 288 past that (csrc/ydrop_chunk.cu)."""
    if width <= 160:
        return 1
    for cpt in (3, 5):
        if width <= 4 * 32 * cpt:
            return -(-width // (32 * cpt))
    return -(-width // 288)


def _on(dev, a):
    if isinstance(a, dict):
        return {k: _on(dev, v) for k, v in a.items()}
    if torch.is_tensor(a):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _assert_equal(got, want, names, what):
    """Every output of a kernel call against its plain version's."""
    for k in tx.STATE_KEYS:
        assert torch.equal(got[0][k].cpu(), want[0][k]), f"{what}: {k}"
    for name, a, b in zip(names, got[1:], want[1:]):
        if b is None:
            assert a is None, f"{what}: {name}"
        else:
            assert torch.equal(a.cpu(), b), f"{what}: {name}"


MEGA_NAMES = ("prev_off", "packed", "tb_all", "row_lo", "row_hi", "col0")
# y-drops whose bands (in the main path's 1536-column window) take one
# tile on warp 0 only (87 to 124 columns: narrow-only lanes), two tiles
# (185 to 250 columns), four tiles in a round (300 to 397), more than
# four (two rounds: up to 1446 columns), and bands past the window
LAYOUT_CASES = {"one_tile": 3000, "two_tiles": 6000, "four_tiles": 9400,
                "rounds": 36000, "overflow": 60000}


@pytest.mark.cuda
@pytest.mark.parametrize("with_tb", [True, False], ids=["links", "scores"])
@pytest.mark.parametrize("trim", [True, False], ids=["trim", "notrim"])
@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_cuda_k1_warp_layout(case, trim, with_tb):
    """K1's mega launch and its chunk entry, four warps a lane, against
    their plain versions on bands of each tile class of LAYOUT_CASES,
    with a lane that ends in its first chunk (M = 60) beside lanes that
    run both blocks, and a lane truncated by tb_cap a few rows in."""
    dev = _card()
    cpu = torch.device("cpu")
    seqs, lane, st_np, subsmall, kw = _mega_inputs(
        seed=5, n=6000, Bh=3, W=1536, y_drop=LAYOUT_CASES[case], rows=128,
        max_blocks=2)
    kw["trim_to_peak"] = trim
    lane = tuple(a.copy() for a in lane)
    lane[7][1] = 60                         # M: ends in the first chunk
    st_np = {k: v.copy() for k, v in st_np.items()}
    tail = tx.y_drop_tail(kw["y_drop"], kw["gap_e"])
    st_np["tbp"][2] = kw["tb_cap"] - tail - 3000   # truncated rows in
    B = lane[0].shape[0]
    args = (*seqs, *lane, st_np, np.zeros(B, np.int32), subsmall)
    got = ydrop_mega(*(_on(dev, a) for a in args), with_tb=with_tb, **kw)
    bands = []
    want = tx.ydrop_mega_plain(*(_on(cpu, a) for a in args), with_tb=with_tb,
                               bands=bands, **kw)
    _assert_equal(got, want, MEGA_NAMES, f"mega {case}")
    tiles = [_k1_tiles(int(w)) for w in np.concatenate(tx.lane_bands(bands))]
    nblk, status = want[2][12], want[0]["status"]
    if case == "one_tile":
        assert max(tiles) == 1
    elif case == "overflow":
        assert bool((status & tx.ST_WIDTH_OVERFLOW).any())
    else:
        need = {"two_tiles": 2, "four_tiles": 4, "rounds": 5}[case]
        assert need in tiles or (need == 5 and max(tiles) > 4)
        assert int(nblk[1]) == 1 and int(nblk.max()) == kw["max_blocks"]
        assert int(status[2]) & tx.ST_TRUNCATED
        assert int(want[0]["rows_used"][2]) > 0
    # the chunk entry on the first chunk's windows
    ckw = {k: v for k, v in kw.items() if k != "max_blocks"}
    st0 = _on(cpu, st_np)
    a_win, b_win = tx.gather_windows(
        *(_on(cpu, a) for a in seqs + lane[:7]), st0["row"] - 1, st0["LY"],
        kw["rows"], kw["lanes"])
    cargs = (a_win, b_win, st0["LY"], st0["LY"], *(_on(cpu, a)
                                                    for a in lane[7:]))
    cgot = ydrop_chunk(*(_on(dev, a) for a in cargs), _on(dev, st_np),
                       _on(dev, subsmall), want_tb=with_tb, **ckw)
    cwant = tx.ydrop_chunk_plain(*cargs, st0, _on(cpu, subsmall), **ckw)
    _assert_equal(cgot, (cwant[0], cwant[1] if with_tb else None),
                  ("tb",), f"chunk {case}")


def _tie_inputs(W=1536, rows=4, trim=True):
    """Chunk-entry inputs whose first row ties: lanes with bands of 90,
    300, 600, 1000 and 1400 columns from column 0, CC flat over the band
    (every cell of the first row equal) or flat with two equal peaks in
    tiles of different warps, DD far below, every code the same; a lane
    with M = 1 makes every cell a boundary cell (untrimmed)."""
    sc = new_dna_score_set()
    seq = np.frombuffer(b"ACGT" * 4, np.uint8)
    code_map, subsmall = tx.make_compact_alphabet([seq, seq], sc.sub)
    ge = int(sc.gap_extend)
    goe = int(sc.gap_open + sc.gap_extend)
    widths = [90, 300, 600, 1000, 1400]
    lanes = [(w, peaks, m) for w in widths for peaks in (0, 1)
             for m in (1000, 1)]
    B = len(lanes)
    CC = np.full((B, W), tx.NEG, np.int32)
    DD = np.full((B, W), -1_000_000, np.int32)
    st = {k: np.zeros(B, np.int32) for k in tx.SCALAR_KEYS}
    M = np.empty(B, np.int32)
    for b, (w, peaks, m) in enumerate(lanes):
        CC[b, :w] = 1000
        if peaks:
            CC[b, [w // 8, w - w // 6]] = 3000
        st["RY"][b] = w
        st["maxRY"][b] = w
        M[b] = m
    st["row"][:] = 1
    st["bflag"] = st["bflag"].astype(bool)
    st["done"] = np.zeros(B, bool)
    st.update(CC=CC, DD=DD)
    a_small = np.full((B, rows), code_map[ord("A")], np.int32)
    b_small = np.full((B, W), code_map[ord("A")], np.int32)
    zero = np.zeros(B, np.int32)
    N = np.full(B, 5000, np.int32)
    kw = dict(gap_e=ge, gap_oe=goe, y_drop=9400, lanes=W, rows=rows,
              alpha=16, trim_to_peak=trim, tb_cap=80 * 1024 * 1024)
    return (a_small, b_small, zero, zero, M, N), st, subsmall, kw, lanes


@pytest.mark.cuda
@pytest.mark.parametrize("with_tb", [True, False], ids=["links", "scores"])
@pytest.mark.parametrize("trim", [True, False], ids=["trim", "notrim"])
def test_cuda_k1_ties_across_warps(trim, with_tb):
    """K1's chunk entry on rows whose maximum is reached by equal cells
    in the tiles of several warps (a flat band, or two equal peaks in
    two warps' tiles; untrimmed, every cell a boundary cell on lanes
    with M = 1): the highest column wins, as in the plain version, and
    every output equals it, for one row and for four."""
    dev = _card()
    cpu = torch.device("cpu")
    for rows in (1, 4):
        args, st, subsmall, kw, lanes = _tie_inputs(rows=rows, trim=trim)
        got = ydrop_chunk(*(_on(dev, a) for a in args), _on(dev, st),
                          _on(dev, subsmall), want_tb=with_tb, **kw)
        want = tx.ydrop_chunk_plain(*(_on(cpu, a) for a in args),
                                    _on(cpu, st), _on(cpu, subsmall), **kw)
        _assert_equal(got, (want[0], want[1] if with_tb else None),
                      ("tb",), f"ties rows={rows}")
        if rows == 1:
            end2 = want[0]["end2"].tolist()
            for b, (w, peaks, m) in enumerate(lanes):
                # the last eligible column, or the right peak's next one
                assert end2[b] == (w - w // 6 + 1 if peaks else w - 1), b


@pytest.mark.cuda
@pytest.mark.parametrize("with_tb", [True, False], ids=["links", "scores"])
@pytest.mark.parametrize("shift", [37, 300, 1000, 1600])
def test_cuda_mega_reanchor_shift(shift, with_tb):
    """K1's mega launch resumed with its window origin `shift` columns
    left of the lanes' LY, so that the in-place re-anchor moves CC/DD
    across the 128 columns its threads take a step (and past the
    window, 1600), against the plain version."""
    dev = _card()
    cpu = torch.device("cpu")
    seqs, lane, st_np, subsmall, kw = _mega_inputs(
        seed=5, n=6000, Bh=2, W=1536, y_drop=9400, rows=128, max_blocks=1)
    B = lane[0].shape[0]
    first = tx.ydrop_mega_plain(
        *(_on(cpu, a) for a in (*seqs, *lane, st_np, np.zeros(B, np.int32),
                                subsmall)), **kw)
    prev = first[1] - shift
    args = (*seqs, *lane, first[0], prev, subsmall)
    got = ydrop_mega(*(_on(dev, a) for a in args), with_tb=with_tb, **kw)
    want = tx.ydrop_mega_plain(*(_on(cpu, a) for a in args),
                               with_tb=with_tb, **kw)
    _assert_equal(got, want, MEGA_NAMES, f"shift {shift}")
    assert bool((want[2][12] == 1).all())


@pytest.mark.cuda
def test_cuda_xdrop_matches_plain():
    """K2 against its plain version, both directions."""
    dev = _card()
    s1, s2 = _related_pair(20000, seed=3)
    state = carry_state(s1, s2, new_dna_score_set().sub, dev)
    rng = np.random.default_rng(1)
    H = 50000
    pos1 = rng.integers(19, len(s1), H)
    pos2 = np.where(rng.random(H) < 0.5, pos1, rng.integers(19, len(s2), H))
    diag = pos1 - pos2
    n_l = pos1 - np.maximum(diag, 0)
    n_r = np.maximum(np.minimum(len(s1), len(s2) + diag) - pos1, 0)
    t = [torch.from_numpy(a).to(dev) for a in (pos1, pos2, n_l, n_r)]
    args = (state["seq1p"], state["seq2p"], state["subsmall_t"].reshape(-1),
            16)
    n0 = xdrop_scan.launches
    got = xdrop_scan(*args, *t, 910)
    assert xdrop_scan.launches == n0 + 1
    want = xdrop_scan(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                      *(a.cpu() for a in t), 910)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("band,rows", [(64, 128), (512, 1024), (32, 64),
                                       (96, 200), (1024, 300), (64, 1)])
@pytest.mark.parametrize("y_drop", [300, 10 ** 7])
def test_cuda_wavefront_and_band_match_plain(band, rows, y_drop):
    """K3 and K3b against their plain versions on the same card
    tensors: related code pairs with ragged ends, one anchor that
    scores below 0 everywhere, one whose band dies within its first
    rows, one with -1 codes inside codes1 (an off-grid row leaves D
    alive), one identical pair that never dies, a batch that is no
    multiple of 32; K3's strip widths 2, 16, 1, 3, 32 and a single
    row."""
    dev = _card()
    rng = np.random.default_rng(band + y_drop % 7)
    B = 70
    sub4 = new_dna_score_set().dna4.astype(np.int32)
    base = rng.integers(0, 4, (B, max(rows, band))).astype(np.int32)
    C1 = base[:, :rows].copy()
    C2 = base[:, :band].copy()
    mut = rng.random(C2.shape) < 0.15
    C2[mut] = (C2[mut] + 1) % 4
    for i in range(B):
        C1[i, int(rng.integers(rows // 2, rows + 1)):] = -1
        C2[i, int(rng.integers(band // 2, band)):] = -1
    C1[3] = np.where(C1[3] >= 0, 0, -1)
    C2[3] = np.where(C2[3] >= 0, 3, -1)
    C2[4] = np.where(C2[4] >= 0, (base[4, :band] + 2) % 4, -1)  # dies early
    C1[5, 3: 3 + max(rows // 8, 1)] = -1  # off-grid rows inside
    C1[6] = base[6, :rows]  # never dies: a perfect match to its end
    C2[6] = base[6, :band]
    P = np.tile(np.array([30, 430, y_drop, band - 1], np.int32), (B, 1))
    args = [torch.from_numpy(a).to(dev) for a in (C1, C2, sub4, P)]
    for fn, plain in ((tp.ydrop_extend_batch, tp.ydrop_wavefront_plain),
                      (tp.ydrop_band_batch, tp.ydrop_band_plain)):
        n0 = fn.launches
        got = fn(*args, band=band, max_rows=rows)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        want = plain(*args, band=band, max_rows=rows)
        assert torch.equal(got, want), fn.__name__
        assert int(got[:, 0].max()) > 0


def _band_inputs(band, rows, case, B=70):
    """K3b's inputs for test_cuda_band_matches_plain: related code pairs
    with ragged ends and -1 codes inside codes1 at the default gaps and a
    y-drop of 300 ("pruning"), the same at gap_e 0 ("gap_e0"), or A
    against A at zero gap costs, fewer rows than columns and codes2 cut
    after column L_i > rows ("ties"): every cell of row r from column
    r + 1 on scores 91 (r + 1), so columns rows .. L_i, across lanes,
    share the best on the last row, and L_i wins the tie."""
    rng = np.random.default_rng(band + rows)
    sub4 = new_dna_score_set().dna4.astype(np.int32)
    base = rng.integers(0, 4, (B, max(rows, band))).astype(np.int32)
    C1 = base[:, :rows].copy()
    C2 = base[:, :band].copy()
    if case == "ties":
        C1[:] = 0
        C2[:] = 0
        for i in range(B):
            C2[i, int(rng.integers(rows + 1, band)):] = -1
        gaps = (0, 0)
    else:
        mut = rng.random(C2.shape) < 0.15
        C2[mut] = (C2[mut] + 1) % 4
        for i in range(B):
            C1[i, int(rng.integers(rows // 2, rows + 1)):] = -1
            C2[i, int(rng.integers(band // 2, band)):] = -1
        C1[5, 3: 3 + max(rows // 8, 1)] = -1  # off-grid rows inside
        gaps = (0, 430) if case == "gap_e0" else (30, 430)
    P = np.tile(np.array([*gaps, 300, band - 1], np.int32), (B, 1))
    return C1, C2, sub4, P


@pytest.mark.cuda
@pytest.mark.parametrize("band", [32, 64, 96, 512, 1024])
@pytest.mark.parametrize("case", ["pruning", "gap_e0", "ties"])
def test_cuda_band_matches_plain(band, case):
    """K3b against its plain version at every strip class (S = 1, 2, 3,
    16 and 32 columns a lane), on a batch of 70 anchors (no multiple of
    the kernel's 8 a CTA), one launch a call; and its early stop: the
    kernel on codes1 cut to -1 past ydrop_band_rows gives the same
    result as on the full codes1."""
    dev = _card()
    rows = band // 2 if case == "ties" else 300
    C1, C2, sub4, P = _band_inputs(band, rows, case)
    args = [torch.from_numpy(a).to(dev) for a in (C1, C2, sub4, P)]
    geo = dict(band=band, max_rows=rows)
    n0 = tp.ydrop_band_batch.launches
    got = tp.ydrop_band_batch(*args, **geo)
    torch.cuda.synchronize()
    assert tp.ydrop_band_batch.launches == n0 + 1
    want = tp.ydrop_band_plain(*args, **geo)
    assert torch.equal(got, want)
    if case == "ties":
        assert (got[:, 0] == 91 * rows).all()
        assert torch.equal(got[:, 2], (args[1] >= 0).sum(1).to(torch.int32))
    stop = tp.ydrop_band_rows(*args, **geo)
    if case == "pruning":
        assert int((stop < rows).sum()) > 0
    again = tp.ydrop_band_batch(cut_codes(args[0], stop), *args[1:], **geo)
    assert tp.ydrop_band_batch.launches == n0 + 2
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", WALK_EDGE_CAPS)
@pytest.mark.parametrize("geometry", WALK_EDGE_GEOMETRY)
def test_cuda_walk_edges(geometry, cap):
    """The traceback kernel against its plain version on synthetic
    blocks (chip_smoke.walk_inputs): caps at the edges of its 8-step
    groups and 64-row tiles, and to the end of every walk (None); walks
    that cross blocks and meet the lane, local, column-0 and row-0
    edges."""
    dev = _card()
    K, R1, W = geometry
    args = [torch.from_numpy(a) for a in walk_inputs(1, K=K, R1=R1, W=W)]
    cap = cap or K * R1 + W + 512
    n0 = traceback_mega.launches
    got = traceback_mega(*(a.to(dev) for a in args), cap)
    assert traceback_mega.launches == n0 + 1
    want = traceback_mega(*args, cap)
    for name, a, b in zip(("ops", "n", "row", "col"), got, want):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", XDROP_EDGES)
def test_cuda_xdrop_edges(case):
    """K2 against its plain version at its stage and chunk edges, both
    directions."""
    dev = _card()
    arrays, x_drop, expect = xdrop_edge_inputs(case)
    s1, s2, sub, *rest = (torch.from_numpy(a) for a in arrays)
    n0 = xdrop_scan.launches
    got = xdrop_scan(s1.to(dev), s2.to(dev), sub.to(dev), 4,
                     *(a.to(dev) for a in rest), x_drop)
    assert xdrop_scan.launches == n0 + 1
    want = xdrop_scan(s1, s2, sub, 4, *rest, x_drop)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)
    for side in want:
        assert tuple(int(a[0]) for a in side) == expect


@pytest.mark.cuda
@pytest.mark.parametrize("recover", [False, True], ids=["simple", "recover"])
@pytest.mark.parametrize("case", CHAIN_EDGES)
def test_cuda_chain_walk_edges(case, recover):
    """csrc/resolve_chains.cu against its plain version at the real
    chain cap, both modes."""
    from lastz_tpu_torch.ops.hitgen import RESOLVE_CHAIN_CAP
    from lastz_tpu_torch.ops.resolve_cuda import resolve_chains
    dev = _card()
    arrays = chain_edge_inputs(case, RESOLVE_CHAIN_CAP)
    cpu = chain_walk_args(arrays, recover)
    n = resolve_chains.launches
    got = resolve_chains(*(a.to(dev) for a in cpu))
    torch.cuda.synchronize()
    assert resolve_chains.launches == n + 1
    want = resolve_chains(*cpu)
    assert got[-1] == want[-1] == (case != "cap_over")
    for a, b in zip(got[:-1], want[:-1]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,step", [("1110100110010101111", 1),
                                          ("11111111111", 3)])
def test_cuda_device_table_matches_host(pattern, step):
    """The position table built on the card equals the host build."""
    from lastz_tpu_torch.core.encoding import UPPER_NUC_TO_BITS
    from lastz_tpu_torch.core.seeds import parse_seed
    from lastz_tpu_torch.index.postable import (
        build_seed_position_table, build_seed_position_table_device)
    dev = _card()
    s1, _ = _related_pair(200_000, seed=9)
    s1[1000:1300] = ord("N")
    s1[5000:9000] += 32  # lowercase
    seed = parse_seed(pattern)
    host = build_seed_position_table(s1, 0, 0, UPPER_NUC_TO_BITS, seed, step)
    got = build_seed_position_table_device(s1, 0, 0, UPPER_NUC_TO_BITS, seed,
                                           step, device=dev)
    assert got.dev_csr_start.is_cuda and got.n_entries == len(host.csr_pos)
    assert np.array_equal(got.csr_start, host.csr_start)
    assert np.array_equal(got.csr_pos.astype(np.int64),
                          host.csr_pos.astype(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["--twins=20..200"]],
                         ids=["default", "twins"])
def test_cuda_farm_matches_serial(tmp_path, extra):
    """The query farm-out on the card, two workers on card 0
    (chip_smoke.py's farm phase at a small size): the serial run's
    output; each worker launched the main path's four kernels (the
    batched search's K2 with --twins) on one non-default stream of its
    own; the device-built table never fetched, no upload made twice on
    a stream."""
    from chip_smoke import (FARM_SLOTS, MAIN_ENTRIES, entry_streams,
                            farm_report, farm_run, require_in_place,
                            require_single_uploads, table_watch,
                            upload_watch, write_queries)
    _card()
    rng = np.random.default_rng(17)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    t = alpha[rng.integers(0, 4, 300_000)]
    parts = []
    for a in rng.integers(0, len(t) - 3000, 6):  # alignments the card
        seg = t[a:a + 3000].copy()                # extends to their end
        mut = rng.random(len(seg)) < 0.12
        seg[mut] = alpha[rng.integers(0, 4, mut.sum())]
        parts.append(seg)
    tp, qp = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
    write_queries(tp, t, 1)
    write_queries(qp, np.concatenate(parts), 6)
    argv = [tp, qp, *extra]
    out = []
    for slots in (None, FARM_SLOTS):
        out.append(str(tmp_path / f"{len(slots or [])}.lav"))
        _, launches, st, _, (_, seen, made, built) = farm_run(
            argv, out[-1], slots, entry_streams(), upload_watch(),
            table_watch())
        if not extra:  # the batched search reads the table's host copy
            require_in_place(built, "farm test")
        require_single_uploads(made, "farm test")
        assert st.gapped_device > 0
    # the batched search (--twins) has no chain walk
    farm_report(seen, len(FARM_SLOTS), "farm test",
                need=("xdrop_scan",) if extra else tuple(MAIN_ENTRIES))
    with open(out[0]) as a, open(out[1]) as b:
        serial = a.read()
        assert serial == b.read() and serial.count("a {") >= 6


def _index_like_target(n, seed):
    """Random ACGT with lowercase and N runs (make_index_target's recipe
    at n bases)."""
    rng = np.random.default_rng(seed)
    t = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for a, m in zip(rng.integers(0, n - 2000, n // 10_000),
                    rng.integers(100, 1500, n // 10_000)):
        t[a: a + m] |= 0x20
    for a, m in zip(rng.integers(0, n - 600, n // 100_000 + 1),
                    rng.integers(10, 500, n // 100_000 + 1)):
        t[a: a + m] = ord("N")
    return t


@pytest.mark.cuda
def test_cuda_sharded_search_matches_device_search():
    """chip_smoke.py's shard phase (b) at a small size: the sharded
    search on four shards of card 0 (K2 on every shard) against the
    port's unsharded device search, hit for hit."""
    from chip_smoke import shard_index_target
    _card()
    launches = shard_index_target("test", _index_like_target(400_000, 2),
                                  query_bp=60_000)
    assert launches["xdrop_scan"] > 0


@pytest.mark.cuda
def test_cuda_sharded_ydrop_matches_whole(monkeypatch):
    """Phase (c) at tests/test_ydrop_sharded.py's size: ShardedTargetYDrop
    on four shards of card 0, lane for lane equal to DeviceYDrop, through
    K1's mega launch (continuations included) and the walk."""
    from chip_smoke import shard_gapped
    from lastz_tpu_torch.align import ydrop_device as tydd
    from lastz_tpu_torch.core.encoding import UPPER_NUC_TO_BITS
    from lastz_tpu_torch.core.seeds import SEED_12OF19, parse_seed
    from lastz_tpu_torch.search.sharded_mesh import MeshShardedIndex
    dev = _card()
    rng = np.random.default_rng(7)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    s1 = alpha[rng.integers(0, 4, 30000)]
    s2m = s1[2000:9000].copy()
    mut = rng.random(len(s2m)) < 0.10
    s2m[mut] = alpha[rng.integers(0, 4, mut.sum())]
    s2 = np.concatenate([alpha[rng.integers(0, 4, 400)], s2m,
                         s1[13000:18000].copy(),
                         alpha[rng.integers(0, 4, 600)]])
    monkeypatch.setattr(tydd, "DEFAULT_ROWS", 64)
    monkeypatch.setattr(tydd, "DEFAULT_BATCH", 8)
    sc = new_dna_score_set()
    index = MeshShardedIndex(s1, UPPER_NUC_TO_BITS,
                             parse_seed(SEED_12OF19, with_trans=1), 1, 4,
                             sc.sub, ext_halo=2048, slots=["cuda:0"] * 4)
    seg_infos = [(a1, a2, 0, len(s1), 0, len(s2)) for a1, a2 in
                 [(2600, 1000), (5000, 3400), (8500, 6900), (14000, 8400),
                  (16800, 11200)]]
    launches = shard_gapped("test", (s1, s2, sc, 3400, False, 80 << 20,
                                     seg_infos, dev), index)
    assert launches["ydrop_mega"] > 1  # continuations re-extracted


@pytest.mark.cuda
def test_cuda_mesh_step_matches_cpu():
    """Phase (d) at a small size: the mesh step on four slots of card 0,
    on one slot and on CPU tensors, every output equal, through K1's
    chunk entry and K2."""
    from chip_smoke import shard_mesh_step
    _card()
    rng = np.random.default_rng(4)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    t = alpha[rng.integers(0, 4, 200_000)]
    q = t[50_000:70_000].copy()
    mut = rng.random(len(q)) < 0.08
    q[mut] = alpha[rng.integers(0, 4, mut.sum())]
    launches = shard_mesh_step("test", (t, q, None),
                               dict(q_per_shard=2, qlen=2048,
                                    anchors_per_shard=8))
    assert launches["ydrop_chunk"] == 4 and launches["xdrop_scan"] == 4


@pytest.mark.cuda
def test_cuda_sharded_cli_matches_unsharded():
    """Phase (a) at a small size: the port's CLI under
    LASTZ_TORCH_SHARDS=4 on four slots of card 0, unsharded and sharded
    in turns, the same LAV, K2 on every shard and no seed host search."""
    import os
    import tempfile
    from chip_smoke import TDIR, run_port, shard_cli, write_pair
    _card()
    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    t = alpha[rng.integers(0, 4, 300_000)]
    parts = []
    for a in rng.integers(0, len(t) - 3000, 8):
        seg = t[a:a + 3000].copy()
        mut = rng.random(len(seg)) < 0.12
        seg[mut] = alpha[rng.integers(0, 4, mut.sum())]
        parts += [alpha[rng.integers(0, 4, 1000)], seg]
    pair = (t, np.concatenate(parts), None)
    with tempfile.TemporaryDirectory() as tdir:
        tp, qp, _, _ = write_pair(tdir, pair)
        out = os.path.join(tdir, "ref.lav")
        run_port([tp, qp, "--stats"], out)
        with open(out, "rb") as f:
            ref = f.read().replace(tdir.encode(), TDIR)
    assert ref.count(b"a {") >= 8
    launches, args, index = shard_cli("test", pair, ref)
    assert launches["xdrop_scan"] > 0 and index.n_shards == 4
    assert len(args[6]) > 0  # the gapped stage's anchors


@pytest.mark.cuda
def test_cuda_profile_records_spans_on_its_clock():
    """Under a CUDA-only torch.profiler profile, as the benchmark's
    traced run makes it, the program records its spans with no switch
    of its own, and a span around a kernel and its synchronise holds
    the kernel's device interval once mapped onto the profile's clock
    (stats.Trace.unix_ns less the profile's start), within 100 us."""
    import time
    from lastz_tpu_torch import stats
    _card()
    st = stats.RunStats()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    n0 = len(stats.recorded().spans)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            with st.time(f"span{i}"):
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize()
            time.sleep(0.5)
    tr = stats.recorded()
    spans = tr.spans[n0:]
    assert [s.name for s in spans] == ["span0", "span1", "span2"]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if str(getattr(e, "device_type", "")).endswith("CUDA"))
    assert len(kernels) == 3, kernels

    def us(t):
        return (tr.unix_ns(t) - start_ns) / 1e3

    for (a, b), s in zip(kernels, spans):
        assert us(s.t0) - 100 <= a and b <= us(s.t1) + 100, (a, b, s.name)
        assert b - a > 1000
