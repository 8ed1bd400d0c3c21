"""Exact batched one-sided y-drop DP with traceback: the plain PyTorch
version of K1 and the glue programs around it.

Port of lastz_tpu/ops/ydrop_exact.py (reference row sweep
gapped_extend.c:3388-3860).  For every anchor it reproduces the host
engine's results exactly for the unconstrained case: scores, end
cells, per-cell traceback link bytes, the y-drop band walk (LY/RY) and
the truncation semantics.  Each DP row runs the two-pass scheme of
docs/two_pass_exact_row.md: a reset-free decayed prefix max fixes the
prune, branch and best decisions, then one reset scan gives the exact
insertion values the link bytes need.

  ydrop_chunk_plain    up to `rows` DP rows per anchor, resumable
                       (_chunk_one/ydrop_chunk, :212/:455); the CPU
                       path of ops/ydrop_cuda.ydrop_chunk and the
                       oracle of csrc/ydrop_chunk.cu
  ydrop_mega_plain     <= max_blocks chunks of every lane in lockstep,
                       the window gather written as index arithmetic
                       (_mega_one/ydrop_mega, :568/:644); the CPU path
                       of ops/ydrop_cuda.ydrop_mega and the oracle of
                       its kernel, ydrop_mega_launch in
                       csrc/ydrop_chunk.cu
  ydrop_mega_lanes_plain  the same, one lane at a time
  traceback_mega_plain the link-byte walk over the retained blocks
                       (traceback_mega_dev, :675-736); the oracle of
                       csrc/ydrop_traceback.cu

Everything is int32, as in the JAX version, and `//` is floor division
where JAX uses it.  The constants, make_compact_alphabet and
fresh_state_np are copied, not imported: their source module imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.scoring import NEG_INFINITY_SCORE
from ..kernels import build

C_FROM_C = 0
C_FROM_I = 1
C_FROM_D = 2
I_EXTEND = 4
D_EXTEND = 8
CID_BITS = 3

NEG = int(np.int32(NEG_INFINITY_SCORE))  # -1932735283
SENT32 = -(1 << 30)                      # "no candidate" (row maxima)
# i-chain identity: below every reachable value yet far enough from
# INT32_MIN that the decay compensation never wraps (ydrop_exact.py:88)
ISENT = -2_080_000_000
MAX_COMP_GAP_E = 60_000                  # glue-enforced cap on gapExtend
BIG = 1 << 30

ST_WIDTH_OVERFLOW = 1   # band wider than the static window
ST_TRUNCATED = 8        # traceback arena exhausted (reference semantic)

STATE_KEYS = ("CC", "DD", "LY", "RY", "row", "best", "end1", "end2",
              "bscore", "bflag", "tbp", "rows_used", "maxRY",
              "status", "done")
# per-lane scalars in the order the CUDA kernel packs them
SCALAR_KEYS = STATE_KEYS[2:]

OP_S = 1
OP_I = 2
OP_D = 3

_I32 = torch.int32


def present_codes(a) -> np.ndarray:
    """The byte codes present in one array, a 256-entry bool mask."""
    a = np.asarray(a)
    if a.dtype == np.uint8:  # a count is a tenth of a sort's time
        return np.bincount(a.ravel(), minlength=256) > 0
    present = np.zeros(256, bool)
    present[np.unique(a)] = True
    return present


def make_compact_alphabet(arrays, sub, max_k=16):
    """Compact alphabet over the byte codes present in `arrays` (plus
    NUL); returns (code_map[256] -> small index, subsmall (K,K) int32)
    or None when more than max_k codes occur."""
    return compact_alphabet([present_codes(a) for a in arrays], sub, max_k)


def compact_alphabet(masks, sub, max_k=16):
    """make_compact_alphabet from the arrays' present_codes masks, so
    that each array's part can be computed (and timed) on its own."""
    present = np.zeros(256, bool)
    present[0] = True
    for m in masks:
        present |= m
    codes = np.nonzero(present)[0]
    if len(codes) > max_k:
        return None
    code_map = np.zeros(256, np.int32)
    code_map[codes] = np.arange(len(codes), dtype=np.int32)
    subsmall = np.zeros((max_k, max_k), np.int32)
    subsmall[:len(codes), :len(codes)] = \
        sub[np.ix_(codes, codes)].astype(np.int32)
    return code_map, subsmall


def fresh_state_np(N, gap_e, gap_oe, y_drop, lanes, batch):
    """Closed-form first DP row (gapped_extend.c:3550-3582), computed
    host-side: C(0,0)=0, C(0,j)=-gapOE-(j-1)*gapE while the previous
    value stays >= -yDrop.  Returns the resumable state dict (numpy,
    CC/DD with window origin 0) plus the row-0 link bytes (col 0 -> 0,
    others C_FROM_I)."""
    W = lanes
    B = batch
    j = np.arange(W, dtype=np.int64)
    c0 = np.where(j == 0, 0, -gap_oe - (j - 1) * gap_e)
    c0_prev = np.where(j <= 1, 0, -gap_oe - (j - 2) * gap_e)
    writable = ((j >= 1) & (c0_prev >= -y_drop))[None, :] \
        & (j[None, :] <= np.asarray(N)[:, None])
    RY0 = 1 + writable.sum(axis=1).astype(np.int32)
    in0 = j[None, :] < RY0[:, None]
    CC = np.where(in0, c0[None, :], NEG).astype(np.int32)
    DD = np.where(in0, c0[None, :] - gap_oe, NEG).astype(np.int32)
    row0_links = np.where(in0 & (j[None, :] >= 1),
                          np.uint8(C_FROM_I), np.uint8(0))
    init_over = RY0 > W
    st = dict(
        CC=CC, DD=DD,
        LY=np.zeros(B, np.int32), RY=RY0,
        row=np.ones(B, np.int32),
        best=np.zeros(B, np.int32),
        end1=np.zeros(B, np.int32), end2=np.zeros(B, np.int32),
        bscore=np.full(B, NEG, np.int32),
        bflag=np.zeros(B, bool),
        tbp=RY0.copy(),
        rows_used=np.zeros(B, np.int32),
        maxRY=RY0.copy(),
        status=np.where(init_over, ST_WIDTH_OVERFLOW, 0).astype(np.int32),
        done=init_over.copy(),
    )
    return st, row0_links


def y_drop_tail(y_drop: int, gap_e: int) -> int:
    """Rows of slack the truncation test keeps (gapped_extend.c:3621)."""
    return int(y_drop) // int(gap_e) + 6 if gap_e != 0 else 500 * 1000


# ---------------------------------------------------------------------------
# one chunk: the plain version of K1
# ---------------------------------------------------------------------------


def _shift_right(x, n, fill):
    """x shifted right by n along the last axis, filling with `fill`."""
    pad = torch.full(x.shape[:-1] + (n,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-n]], dim=-1)


def _prefix_max(x, fill):
    """Inclusive prefix max along the last axis, seeded with `fill`
    (the log-shift scan of ydrop_exact.py:112-119)."""
    return torch.clamp(torch.cummax(x, dim=-1).values, min=fill)


def _prefix_max_reset(s, r):
    """Inclusive scan of (s1,r1) x (s2,r2) = (s2 if r2 else
    max(s1,s2), r1|r2), seeded with (ISENT, False) (the Hillis-Steele
    scan of ydrop_exact.py:122-134): a running max that restarts at
    every reset.  Segment k (from the k-th reset on) is lifted above
    every earlier one by k * 2^32 so one cummax serves them all."""
    seg = torch.cumsum(r.to(torch.int64), dim=-1)
    key = (seg << 32) + (s.to(torch.int64) + (1 << 31))
    m = (torch.cummax(key, dim=-1).values & 0xFFFFFFFF) - (1 << 31)
    m = m.to(s.dtype)
    return torch.where(seg == 0, torch.clamp(m, min=ISENT), m)


def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _reanchor(x, shift, W):
    """x re-anchored by `shift` lanes to the left, NEG-filled (the
    concat + dynamic_slice of ydrop_exact.py:232-236, whose start
    index clamps to [0, W])."""
    sh = shift.to(torch.int64).clamp(0, W)[:, None]
    src = torch.arange(W, device=x.device)[None, :] + sh
    got = x.gather(1, src.clamp(max=W - 1))
    return torch.where(src < W, got, torch.full_like(got, NEG))


def ydrop_chunk_plain(a_small, b_small, b_off, shift, M, N, state,
                      subsmall, *, gap_e: int, gap_oe: int, y_drop: int,
                      lanes: int, rows: int, alpha: int,
                      trim_to_peak: bool, tb_cap: int, bands=None):
    """Process up to `rows` DP rows for each of B anchors, resuming
    from `state` (a dict of (B,) / (B, W) tensors whose CC/DD lane
    origin is b_off - shift).  a_small (B, rows) holds the compact
    codes of rows row_base+1 .., b_small (B, W) those of columns
    b_off + l.  Returns (state', tb (B, rows+1, W) uint8) with tb
    indexed by local row; row 0 is zero.  With a list `bands`, each
    row appends (ran (B,) bool, its band width RY - LY (B,))."""
    del alpha  # the table lookup needs no select chain
    dev = a_small.device
    B = a_small.shape[0]
    W = lanes
    tail = y_drop_tail(y_drop, gap_e)
    l_iota = torch.arange(W, dtype=_I32, device=dev)[None, :]
    comp = (l_iota + 1) * gap_e
    b_off = b_off.to(_I32)[:, None]
    M = M.to(_I32)[:, None]
    N = N.to(_I32)[:, None]
    sub = subsmall.to(_I32)
    b_codes = b_small.to(torch.int64)

    def col(k):
        return state[k].to(_I32)[:, None].clone()

    CC = _reanchor(state["CC"].to(_I32), shift, W)
    DD = _reanchor(state["DD"].to(_I32), shift, W)
    LY, RY, row = col("LY"), col("RY"), col("row")
    best, end1, end2 = col("best"), col("end1"), col("end2")
    bscore, bflag, tbp = col("bscore"), col("bflag"), col("tbp")
    rows_used, maxRY = col("rows_used"), col("maxRY")
    status, done = col("status"), state["done"][:, None].clone()
    stopped = done.clone()
    tb = torch.zeros((B, rows + 1, W), dtype=torch.uint8, device=dev)
    NEGt = torch.tensor(NEG, dtype=_I32, device=dev)
    zero = torch.zeros((), dtype=_I32, device=dev)

    for r in range(rows):
        if bool(stopped.all()):
            break
        tb_needed = torch.clamp(RY - LY, min=0) + tail
        trunc = ~stopped & (tbp + tb_needed >= tb_cap)

        srow = sub[a_small[:, r].to(torch.int64)]          # (B, K)
        s_vals = srow.gather(1, b_codes)

        LYr = LY - b_off
        RYr = RY - b_off
        active = (l_iota >= LYr) & (l_iota < RYr)
        d = torch.where(active, DD, NEGt)
        c_sub = _shift_right(CC, 1, NEG) + s_vals
        c_sub = torch.where(active & (l_iota > LYr), c_sub, NEGt)

        # pass 1: reset-free decayed chain -> exact decisions
        left_dead = l_iota < LYr
        elem_ff = torch.where(active & (d <= c_sub),
                              c_sub - gap_oe + comp, ISENT)
        s_ff = _shift_right(_prefix_max(elem_ff, ISENT), 1, ISENT)
        i_ff = torch.clamp(s_ff - l_iota * gap_e, min=NEG)
        gap = active & ((d > c_sub) | (i_ff > c_sub))
        cand = torch.maximum(torch.maximum(c_sub, d), i_ff)
        c_best = torch.where(active & ~gap, c_sub, SENT32)
        pmax_excl = _shift_right(_prefix_max(c_best, SENT32), 1, SENT32)
        best_before = torch.maximum(best, pmax_excl)
        pruned = active & (cand < best_before - y_drop)

        # pass 2: one reset scan -> exact I values for the links
        reset = pruned | left_dead
        is_seed = active & ~pruned & ~gap
        elem_s = torch.where(
            reset, NEG + comp,
            torch.where(is_seed, c_sub - gap_oe + comp, ISENT))
        s_incl = _prefix_max_reset(elem_s, reset)
        i_vec = _shift_right(s_incl, 1, NEG) - l_iota * gap_e

        c_val = torch.where(gap, torch.maximum(d, i_vec), c_sub)
        c_open = c_sub - gap_oe
        d_dec = d - gap_e
        i_dec = i_vec - gap_e
        link_gap = torch.where(d >= i_vec, C_FROM_D | I_EXTEND | D_EXTEND,
                               C_FROM_I | I_EXTEND | D_EXTEND)
        link_sub = (C_FROM_C
                    | torch.where(c_open > d_dec, 0, D_EXTEND)
                    | torch.where(c_open > i_dec, 0, I_EXTEND))
        dead_cell = pruned | ~active
        link = torch.where(dead_cell, 0,
                           torch.where(gap, link_gap, link_sub))
        CC_cur = torch.where(dead_cell, NEGt, c_val)
        DD_next = torch.where(
            dead_cell, NEGt,
            torch.where(gap, d_dec, torch.maximum(c_open, d_dec)))

        # best / end / boundary: the last column reaching the row max
        elig = active & ~pruned & ~gap
        c_e = torch.where(elig, c_sub, SENT32)
        row_max = c_e.amax(1, keepdim=True)
        fires_best = elig.any(1, keepdim=True) & (row_max >= best)
        k_best = torch.where(elig & (c_e == row_max), l_iota,
                             -1).amax(1, keepdim=True)
        if not trim_to_peak:
            at_b = elig & ((row == M) | (b_off + l_iota == N))
            c_b = torch.where(at_b, c_sub, SENT32)
            b_max = c_b.amax(1, keepdim=True)
            fires_b = at_b.any(1, keepdim=True) & (b_max >= bscore)
            k_b = torch.where(at_b & (c_b == b_max), l_iota,
                              -1).amax(1, keepdim=True)
        else:
            fires_b = torch.zeros_like(fires_best)
            b_max = torch.full_like(row_max, SENT32)
            k_b = torch.full_like(row_max, -1)

        use_b = fires_b & (~fires_best | (k_b >= k_best))
        use_best = fires_best & ~use_b
        end1_n = torch.where(use_b | use_best, row, end1)
        end2_n = torch.where(use_b, b_off + k_b,
                             torch.where(use_best, b_off + k_best, end2))
        bflag_n = torch.where(use_b, 1, torch.where(use_best, 0, bflag))
        best_n = torch.where(fires_best, row_max, best)
        bscore_n = torch.where(fires_b, b_max, bscore)

        notpr = active & ~pruned
        any_live = notpr.any(1, keepdim=True)
        first_live = torch.where(
            any_live, torch.where(notpr, l_iota, BIG).amin(1, keepdim=True),
            RYr)
        LY_new = b_off + first_live
        np_col = b_off + torch.where(notpr, l_iota,
                                     -1).amax(1, keepdim=True)
        dead = LY_new >= RY

        K = RY - LY
        ci = torch.clamp(RYr - 1, 0, W - 1).to(torch.int64)
        i_exit = s_incl.gather(1, ci) - RYr * gap_e
        shrink = RY > np_col + 1
        thresh = best_n - y_drop
        if gap_e != 0:
            p_raw = _floordiv(i_exit - thresh, gap_e) + 1
        else:
            p_raw = torch.full_like(i_exit, BIG)
        p_hi = torch.clamp(N + 1 - RY, min=0)
        p = torch.where(shrink | (i_exit < thresh), zero,
                        torch.minimum(torch.clamp(p_raw, min=0), p_hi))
        RY_shrunk = torch.where(shrink, np_col + 1, RY + p)
        has_sent = RY_shrunk <= N
        RY_final = RY_shrunk + has_sent.to(_I32)

        pj = l_iota - RYr
        is_prolong = (pj >= 0) & (pj < p)
        pro_val = i_exit - pj * gap_e
        CC_new = torch.where(is_prolong, pro_val, CC_cur)
        DD_new = torch.where(is_prolong, pro_val - gap_oe, DD_next)
        is_sent = has_sent & (l_iota == RY_shrunk - b_off)
        CC_new = torch.where(is_sent, NEGt, CC_new)
        DD_new = torch.where(is_sent, NEGt, DD_new)
        tb_row = torch.where(is_prolong, C_FROM_I, link)

        window_end = RY_final - b_off > W
        width_over = (RY_final - LY_new > W) | (K + p > W)
        keep = ~stopped & ~trunc

        status = status | trunc.to(_I32) * ST_TRUNCATED
        status = status | (keep & width_over & ~dead).to(_I32) \
            * ST_WIDTH_OVERFLOW
        done = done | trunc | (keep & (dead | (row >= M) | width_over))
        stopped = stopped | done | (keep & window_end)

        if bands is not None:
            bands.append((keep[:, 0], K[:, 0]))
        tb[:, r + 1] = torch.where(keep, tb_row, 0).to(torch.uint8)
        CC = torch.where(keep, CC_new, CC)
        DD = torch.where(keep, DD_new, DD)
        LY = torch.where(keep, LY_new, LY)
        RY = torch.where(keep, RY_final, RY)
        rows_used = torch.where(keep, row, rows_used)
        row = row + keep.to(_I32)
        best = torch.where(keep, best_n, best)
        end1 = torch.where(keep, end1_n, end1)
        end2 = torch.where(keep, end2_n, end2)
        bscore = torch.where(keep, bscore_n, bscore)
        bflag = torch.where(keep, bflag_n, bflag)
        tbp = torch.where(keep, tbp + K + p, tbp)
        maxRY = torch.maximum(maxRY, torch.where(keep, RY_final, zero))

    out = dict(CC=CC, DD=DD, LY=LY, RY=RY, row=row, best=best,
               end1=end1, end2=end2, bscore=bscore, bflag=bflag != 0,
               tbp=tbp, rows_used=rows_used, maxRY=maxRY, status=status,
               done=done)
    return {k: (v if k in ("CC", "DD") else v[:, 0])
            for k, v in out.items()}, tb


# ---------------------------------------------------------------------------
# mega-launch: a host loop of chunks over resident sequences
# ---------------------------------------------------------------------------


def gather_windows(v1c, v2c, a1, a2, low1, high1, low2, high2, rev,
                   row_base, b_off, rows: int, W: int):
    """Per-lane compact codes of the next chunk's rows (B, rows) and
    window columns (B, W), gathered from the resident sequences with
    the index arithmetic of ydrop_exact.py:605-621.  rev selects the
    reversed (left) orientation: row r reads v1[a1 - row_base - r],
    column c reads v2[a2 + 1 - c]."""
    dev = v1c.device
    r_iota = torch.arange(rows, dtype=_I32, device=dev)[None, :]
    l_iota = torch.arange(W, dtype=_I32, device=dev)[None, :]
    rv = rev[:, None]
    A1, A2 = a1[:, None], a2[:, None]
    rb = row_base[:, None]
    a_idx = torch.where(rv, A1 - rb - r_iota, A1 + 1 + rb + r_iota)
    a_ok = torch.where(rv, a_idx >= low1[:, None],
                       (a_idx < high1[:, None]) & (a_idx >= low1[:, None]))
    a_win = torch.where(
        a_ok, v1c[a_idx.clamp(0, v1c.shape[0] - 1).long()].to(_I32), 0)
    c = b_off[:, None] + l_iota
    b_idx = torch.where(rv, A2 + 1 - c, A2 + c)
    b_ok = torch.where(rv, (b_idx >= low2[:, None]) & (c >= 1),
                       (b_idx < high2[:, None]) & (b_idx >= low2[:, None]))
    b_win = torch.where(
        b_ok, v2c[b_idx.clamp(0, v2c.shape[0] - 1).long()].to(_I32), 0)
    return a_win, b_win


def ydrop_mega_plain(v1c, v2c, a1, a2, low1, high1, low2, high2, rev, M,
                     N, state, prev_off0, subsmall, *, gap_e: int,
                     gap_oe: int, y_drop: int, lanes: int, rows: int,
                     max_blocks: int, alpha: int, trim_to_peak: bool,
                     tb_cap: int, with_tb: bool = True, bands=None):
    """Up to `max_blocks` resumable chunks per lane, same contract as
    the JAX ydrop_mega: returns (state', prev_off', packed (13, B),
    tb_all (B, max_blocks, rows+1, lanes), row_lo, row_hi, col0
    (B, max_blocks)); without `with_tb`, tb_all is (B, 1, 1, 1) zeros.
    With a list `bands`, every row run appends to it as in
    ydrop_chunk_plain (lane_bands reads it).
    The plain version of the mega launch of csrc/ydrop_chunk.cu: all
    lanes in lockstep, a chunk at a time through ydrop_chunk_plain,
    lanes already done riding along unchanged, and one any(~done) read
    on the host per chunk (counted in ydrop_mega_plain.host_reads)."""
    dev = v1c.device
    B = a1.shape[0]
    W = lanes
    kw = dict(gap_e=gap_e, gap_oe=gap_oe, y_drop=y_drop, lanes=W,
              rows=rows, alpha=alpha, trim_to_peak=trim_to_peak,
              tb_cap=tb_cap)
    st = dict(state)
    prev_off = prev_off0.to(_I32)
    nblk = torch.zeros(B, dtype=_I32, device=dev)
    tb_all = torch.zeros((B, max_blocks, rows + 1, W) if with_tb
                         else (B, 1, 1, 1), dtype=torch.uint8, device=dev)
    row_lo = torch.zeros((B, max_blocks), dtype=_I32, device=dev)
    row_hi = torch.zeros_like(row_lo)
    col0 = torch.zeros_like(row_lo)
    for k in range(max_blocks):
        active = ~st["done"]
        build.count(ydrop_mega_plain, "host_reads")
        if not bool(active.any()):
            break
        row_base = st["row"] - 1
        b_off = torch.where(st["done"], prev_off, st["LY"])
        shift = b_off - prev_off
        a_win, b_win = gather_windows(v1c, v2c, a1, a2, low1, high1,
                                      low2, high2, rev, row_base, b_off,
                                      rows, W)
        st, tb = ydrop_chunk_plain(a_win, b_win, b_off, shift, M, N, st,
                                   subsmall, bands=bands, **kw)
        if with_tb:
            tb_all[:, k] = tb
        row_lo[:, k] = torch.where(active, row_base + 1, 0)
        row_hi[:, k] = torch.where(active, st["rows_used"], 0)
        col0[:, k] = torch.where(active, b_off, 0)
        nblk += active.to(_I32)
        prev_off = b_off
    return st, prev_off, pack_scalars(st, nblk), tb_all, row_lo, row_hi, \
        col0


ydrop_mega_plain.host_reads = 0


# The band census's tiles, as K1's one-warp row body swept a band before
# csrc/ydrop_chunk.cu took four warps a lane: bands up to NARROW_TILE
# columns one narrow tile, wider ones tiles of WIDE_TILE columns
NARROW_TILE = 160
WIDE_TILE = 288


def lane_bands(bands):
    """Each lane's band widths, row by row, from the list that
    ydrop_mega_plain(..., bands=list) filled: a list of B int64 numpy
    arrays."""
    if not bands:
        return []
    ran = torch.stack([r for r, _ in bands], 1).cpu().numpy()
    width = torch.stack([w for _, w in bands], 1).cpu().numpy()
    return [width[b][ran[b]].astype(np.int64) for b in range(len(ran))]


def row_tiles(width):
    """The census's tiles for rows of band `width` (numpy array)."""
    w = np.asarray(width, np.int64)
    return np.where(w <= 0, 0, np.where(w <= NARROW_TILE, 1,
                                        -(-w // WIDE_TILE)))


def lane_rows(nblk, row_lo, row_hi):
    """The rows each lane ran in a mega launch, from its outputs: the
    sum over its chunks k < nblk of row_hi - row_lo + 1 (numpy)."""
    nblk = np.asarray(nblk)
    span = np.asarray(row_hi, np.int64) - np.asarray(row_lo, np.int64) + 1
    ran = np.arange(span.shape[1])[None, :] < nblk[:, None]
    return np.where(ran, span, 0).sum(1)


def band_census(widths):
    """The band census of a mega launch from each lane's band widths
    row by row (lane_bands): rows, tiles a row (p50, p90, max) over all
    rows and over the longest lane's rows, and each lane's rows."""
    rows = np.array([len(w) for w in widths], np.int64)
    every = (np.concatenate(widths) if len(widths)
             else np.zeros(0, np.int64))

    def stats(w):
        t = row_tiles(w)
        if not len(t):
            return dict(rows=0)
        return dict(rows=int(len(t)),
                    tiles_p50=float(np.percentile(t, 50)),
                    tiles_p90=float(np.percentile(t, 90)),
                    tiles_max=int(t.max()),
                    width_p50=float(np.percentile(w, 50)),
                    width_p90=float(np.percentile(w, 90)),
                    width_max=int(np.max(w)),
                    rows_by_tiles={int(k): int((t == k).sum())
                                   for k in np.unique(t)})
    longest = int(rows.argmax()) if len(rows) else -1
    return dict(all=stats(every),
                longest_lane=dict(lane=longest, **stats(
                    widths[longest] if len(widths) else every)),
                lane_rows=rows.tolist())


def pack_scalars(st, nblk):
    """The (13, B) int32 block the host fetches after a mega launch:
    row, LY, rows_used, done, status, best, end1, end2, bscore, bflag,
    tbp, maxRY, nblk (ydrop_exact.py:662-667)."""
    return torch.stack([
        st["row"], st["LY"], st["rows_used"], st["done"].to(_I32),
        st["status"], st["best"], st["end1"], st["end2"], st["bscore"],
        st["bflag"].to(_I32), st["tbp"], st["maxRY"], nblk])


def ydrop_mega_lanes_plain(v1c, v2c, a1, a2, low1, high1, low2, high2,
                           rev, M, N, state, prev_off0, subsmall, **kw):
    """ydrop_mega_plain one lane at a time, each lane to its own end (as
    the kernel's warps and the JAX vmap run them), the lanes' results
    concatenated: equal to the lockstep version because no lane reads
    another's state."""
    outs = []
    for b in range(a1.shape[0]):
        sl = slice(b, b + 1)
        outs.append(ydrop_mega_plain(
            v1c, v2c, *(x[sl] for x in (a1, a2, low1, high1, low2, high2,
                                        rev, M, N)),
            {k: v[sl] for k, v in state.items()}, prev_off0[sl], subsmall,
            **kw))
    st = {k: torch.cat([o[0][k] for o in outs]) for k in outs[0][0]}
    packed = torch.cat([o[2] for o in outs], dim=1)
    return (st, torch.cat([o[1] for o in outs]), packed,
            *(torch.cat([o[i] for o in outs]) for i in range(3, 7)))


# ---------------------------------------------------------------------------
# traceback over the retained blocks: the plain version
# ---------------------------------------------------------------------------


def traceback_mega_plain(tb_all, row_lo, row_hi, col0, nblk, end1, end2,
                         want, cap: int):
    """Walk the retained multi-block traceback of every wanted lane in
    lockstep (traceback_mega_dev, ydrop_exact.py:675-736).  Returns
    (ops (B, cap) uint8 walk codes, n (B,), row, col); a finished walk
    ends with row <= 0 and col <= 0.  Same gap-extension-preferring
    link walk as the reference (gapped_extend.c:3845-3860)."""
    del row_hi  # the walk selects blocks by row_lo alone
    dev = tb_all.device
    B, K, R1, W = tb_all.shape
    biota = torch.arange(B, device=dev)
    kiota = torch.arange(K, device=dev)[None, :]
    row = torch.where(want, end1, 0).to(_I32)
    col = torch.where(want, end2, 0).to(_I32)
    prev = torch.zeros(B, dtype=_I32, device=dev)
    n = torch.zeros(B, dtype=_I32, device=dev)
    ops = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    while True:
        act = (row >= 1) | (col > 0)
        if not bool(act.any()) or not bool((n < cap).all()):
            break
        inblk = (kiota < nblk[:, None]) & (row[:, None] >= row_lo)
        blk = torch.clamp(inblk.to(_I32).sum(1) - 1, min=0).long()
        lo = row_lo[biota, blk]
        local = torch.clamp(row - (lo - 1), 0, R1 - 1).long()
        lane = torch.clamp(col - col0[biota, blk], 0, W - 1).long()
        link = tb_all[biota, blk, local, lane].to(_I32)
        op = link & CID_BITS
        op = torch.where((prev == C_FROM_I) & ((link & I_EXTEND) != 0),
                         C_FROM_I, op)
        op = torch.where((prev == C_FROM_D) & ((link & D_EXTEND) != 0),
                         C_FROM_D, op)
        op = torch.where(row == 0, C_FROM_I, op)
        code = torch.where(op == C_FROM_I, OP_I,
                           torch.where(op == C_FROM_D, OP_D, OP_S))
        at = torch.clamp(n, max=cap - 1).long()
        ops[biota, at] = torch.where(act, code, 0).to(torch.uint8)
        row = torch.where(act & (op != C_FROM_I), row - 1, row)
        col = torch.where(act & (op != C_FROM_D), col - 1, col)
        prev = torch.where(act, op, prev)
        n = n + act.to(_I32)
    return ops, n, row, col
