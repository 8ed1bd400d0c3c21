"""The port's CUDA kernels against their plain PyTorch versions on a
card.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest -m cuda tests/test_torch_cuda.py

Each test skips where torch finds no card (a CUDA kernel has no CPU
mode).  The tolerance is exact equality: integer DP state, link bytes,
x-drop results, the (best, row, column) of K3 and K3b, the chain
walk's outputs and the device-built position table."""

import numpy as np
import pytest
import torch

from lastz_tpu_torch.core.scoring import new_dna_score_set
from lastz_tpu_torch.device import carry_state
from lastz_tpu_torch.ops import ydrop_exact as tx
from lastz_tpu_torch.ops import ydrop_pallas as tp
from lastz_tpu_torch.ops.xdrop_cuda import xdrop_scan
from lastz_tpu_torch.ops.ydrop_cuda import traceback_mega, ydrop_chunk

from chip_smoke import (CHAIN_EDGES, WALK_EDGE_CAPS, WALK_EDGE_GEOMETRY,
                        XDROP_EDGES, chain_edge_inputs, chain_walk_args,
                        walk_inputs, xdrop_edge_inputs)
from test_hitgen import _related_pair


def _mega_inputs(seed=21, n=1500, Bh=6, W=256, y_drop=3000, rows=64,
                 max_blocks=4):
    """One small mega launch: Bh anchors near the diagonal of a related
    pair, both directions, 64-row chunks, 4 retained blocks (so some
    lanes finish inside the blocks and some do not)."""
    rng = np.random.default_rng(seed)
    sc = new_dna_score_set()
    alpha = np.frombuffer(b"ACGT", np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < 0.12
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    code_map, subsmall = tx.make_compact_alphabet([s1, s2], sc.sub)
    a1 = rng.integers(50, n - 50, Bh)
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
    return tx.ydrop_mega(*map(up, seqs + lane),
                         {k: up(v) for k, v in state.items()}, up(prev),
                         up(subsmall), with_tb=with_tb, **kw)


@pytest.mark.cuda
def test_cuda_ydrop_matches_plain():
    """K1 through the mega loop, with and without link bytes, and the
    traceback kernel, each against its plain version."""
    dev = _card()
    seqs, lane, st_np, subsmall, kw = _mega_inputs()
    prev0 = np.zeros(lane[0].shape[0], np.int32)
    n0 = ydrop_chunk.launches
    got = _mega(dev, seqs, lane, st_np, prev0, subsmall, kw)
    assert ydrop_chunk.launches > n0
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
@pytest.mark.parametrize("y_drop,min_band", [(9400, 160), (20000, 416)])
def test_cuda_ydrop_wide_band_edges(y_drop, min_band, with_tb):
    """K1 through ydrop_mega, one chunk per call, in the main path's
    window (1536): at its y-drop (9400) bands wider than K1's narrow
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
@pytest.mark.parametrize("band,rows", [(64, 128), (512, 1024)])
@pytest.mark.parametrize("y_drop", [300, 10 ** 7])
def test_cuda_wavefront_and_band_match_plain(band, rows, y_drop):
    """K3 and K3b against their plain versions on the same card
    tensors: related code pairs with ragged ends, one anchor that
    scores below 0 everywhere, a batch that is no multiple of 32."""
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
