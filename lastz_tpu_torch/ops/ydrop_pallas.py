"""Batched score-only y-drop of many anchors: K3 and K3b on the card.

Port of lastz_tpu/ops/ydrop_pallas.py.  Each anchor is extended one
way over a band of columns and up to max_rows rows, with the y-drop
prune relaxed to each column's own running best, so the scores are
never below the reference's and are not exact against LASTZ (the
production gapped stage is ops/ydrop_exact.py, K1).  No production
path calls it; it is the throughput study of the recurrence.

  ydrop_extend_batch      K3, csrc/ydrop_wavefront.cu; replaces
                          _ydrop_wavefront_kernel (:156), launched by
                          ydrop_extend_batch (:285).  Anti-diagonal
                          sweep; plain version ydrop_wavefront_plain
  ydrop_band_batch        K3b, the same CUDA source; replaces
                          _ydrop_band_kernel (:38), which no pallas_call
                          reaches.  Row sweep with the insertion state
                          as a decayed prefix max; plain version
                          ydrop_band_plain
  ydrop_extend_batch_xla  plain PyTorch only: the row sweep with the
                          prune against the anchor's single running
                          best (:344).  It agrees with K3/K3b only
                          while the y-drop never bites
  prepare_anchor_batch    numpy gather of the code slices (:412)

The plain versions of K3 and K3b also count, with live_span=True, the
cells each anchor needs: per DP row, the columns from its first to its
last on-grid cell that survives the prune (the band a y-drop has to
evaluate, as K1's tbp counts it).

The kernels read only row 0 of `params` (gap_e, gap_oe, y_drop); the
column count comes from codes2 < 0.  Every wrapper returns (B, 128)
int32: [:, 0] best, [:, 1] end row, [:, 2] end column, the rest 0.
The wrappers launch their kernel for CUDA tensors, run the plain
version for CPU tensors, and raise for anything else;
`<wrapper>.launches` counts kernel launches and nothing else.  All
arithmetic is int32 and wraps, as XLA's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build

NEG_INF_I32 = -(1 << 30)

_I32 = torch.int32


def _neg(like, shape):
    return torch.full(shape, NEG_INF_I32, dtype=_I32, device=like.device)


def _shift_in(x, fill):
    """x shifted one column right, `fill` (B, 1) entering column 0."""
    return torch.cat([fill, x[:, :-1]], dim=1)


def _pick(planes, a):
    """planes (B, 4, W) at vertical codes a (B, W) or (B, 1): codes 0,
    1 and 2 pick their own plane, anything else plane 3 (the kernels'
    nested selects)."""
    ix = torch.where((a >= 0) & (a < 3), a, 3).to(torch.int64)
    ix = ix.expand(planes.shape[0], planes.shape[2])
    return torch.gather(planes, 1, ix[:, None, :])[:, 0, :]


def _planes(sub4, b_code, col_valid):
    """(B, 4, W) substitution planes: sub4[a][min(b, 3)] on valid
    columns, NEG_INF_I32 // 2 elsewhere."""
    sub = sub4.to(_I32).reshape(4, 4).to(b_code.device)
    b_ix = torch.clamp(b_code, max=3).to(torch.int64)
    planes = torch.stack([sub[a][b_ix] for a in range(4)], dim=1)
    return torch.where(col_valid[:, None, :], planes, NEG_INF_I32 // 2)


def _scalars(params):
    """gap_e, gap_oe, y_drop from row 0 of params, as int32 (1, 1)."""
    p = params[:1, :3].to(_I32)
    return p[:, 0:1], p[:, 1:2], p[:, 2:3]


def _span(lo, hi):
    """Cells from lo to hi per row, 0 where a row has no live cell."""
    return torch.clamp(hi - lo + 1, min=0).sum(dim=1)


def _out(best, end_row, end_col):
    out = torch.zeros((best.shape[0], 128), dtype=_I32, device=best.device)
    out[:, 0] = best
    out[:, 1] = end_row
    out[:, 2] = end_col
    return out


def ydrop_wavefront_plain(codes1, codes2, sub4, params, band: int = 512,
                          max_rows: int = 1024, live_span: bool = False):
    """K3's function in plain PyTorch: lane l holds DP column l+1, and at
    step d (1 .. max_rows + band - 1) lane l computes cell (d-1-l, l+1)
    from the two previous anti-diagonals.  With live_span, returns
    (out, (B,) int64 live-span cells)."""
    c1 = codes1.to(_I32)
    c2 = codes2.to(_I32)
    B = c1.shape[0]
    dev = c1.device
    gap_e, gap_oe, y_drop = (v.to(dev) for v in _scalars(params))
    l_ix = torch.arange(band, dtype=_I32, device=dev)[None, :]
    col_valid = c2 >= 0  # lane l <-> column l+1 consumes codes2[l]
    planes = _planes(sub4, torch.clamp(c2, min=0), col_valid)

    c0row = -gap_oe - l_ix * gap_e  # row-0 boundary C(0, l+1)
    c0row = torch.where((c0row >= -y_drop) & col_valid, c0row, NEG_INF_I32)
    # C(r, 0) for r = 0 .. max_rows + band: the column-0 boundary
    r_ix = torch.arange(max_rows + band + 1, dtype=_I32, device=dev)
    vcol0 = torch.where(r_ix == 0, 0, -gap_oe[0] - (r_ix - 1) * gap_e[0])
    vcol0 = torch.where(vcol0 >= -y_drop[0], vcol0, NEG_INF_I32)

    neg1 = _neg(c1, (B, 1))
    c_m1 = c_m2 = d_m1 = i_m1 = _neg(c1, (B, band))
    a_vec = torch.full((B, band), -1, dtype=_I32, device=dev)
    best = torch.zeros((B, band), dtype=_I32, device=dev)
    d_of_best = torch.zeros((B, band), dtype=_I32, device=dev)
    past_end = torch.full((B, 1), -1, dtype=_I32, device=dev)
    # first and last live lane of each kernel row
    lo = torch.full((B, max_rows), band, dtype=torch.int64, device=dev)
    hi = torch.full((B, max_rows), -1, dtype=torch.int64, device=dev)
    lane = l_ix.to(torch.int64).expand(B, band)
    for d in range(1, max_rows + band):
        # lane l holds codes1[d-1-l] while 0 <= d-1-l < max_rows, else -1
        a_new = c1[:, d - 1: d] if d - 1 < max_rows else past_end
        a_vec = _shift_in(a_vec, a_new)
        on_grid = (a_vec >= 0) & col_valid
        s = _pick(planes, a_vec)
        # lane 0's diagonal input is C(d-1, 0), its left input C(d, 0)
        sub_path = _shift_in(c_m2, vcol0[d - 1].expand(B, 1)) + s
        d_cur = torch.maximum(d_m1 - gap_e, c_m1 - gap_oe)
        left_c = _shift_in(c_m1, vcol0[d].expand(B, 1))
        i_cur = torch.maximum(_shift_in(i_m1, neg1) - gap_e,
                              left_c - gap_oe)
        c_cur = torch.maximum(torch.maximum(sub_path, d_cur), i_cur)
        keep = on_grid & (c_cur >= best - y_drop)
        if live_span:
            r_ix = torch.clamp(d - 1 - lane, 0, max_rows - 1)
            lo.scatter_reduce_(1, r_ix, torch.where(keep, lane, band), "amin")
            hi.scatter_reduce_(1, r_ix, torch.where(keep, lane, -1), "amax")
        c_cur = torch.where(keep, c_cur, NEG_INF_I32)
        c_cur = torch.where(l_ix == d, c0row, c_cur)
        improved = c_cur >= best
        best = torch.where(improved, c_cur, best)
        d_of_best = torch.where(improved, d, d_of_best)
        c_m2, c_m1, d_m1, i_m1 = c_m1, c_cur, d_cur, i_cur

    # latest row at the maximum, then the largest column; rows are
    # reported as r - 1 (kernel row r is DP row r + 1), clamped at 0
    r_of_best = d_of_best - l_ix
    top = best.max(dim=1, keepdim=True).values
    at_max = best == top
    end_row = torch.where(at_max, r_of_best, -1).max(dim=1,
                                                     keepdim=True).values
    end_col = torch.where(at_max & (r_of_best == end_row), l_ix + 1,
                          -1).max(dim=1).values
    out = _out(top[:, 0], torch.clamp(end_row[:, 0] - 1, min=0),
               torch.clamp(end_col, min=0))
    return (out, _span(lo, hi)) if live_span else out


def _row_sweep_setup(c2, sub4, gap_e, gap_oe, y_drop, band):
    """Column layout shared by the row sweeps: DP column c consumes
    codes2[c-1]; column 0 is the boundary."""
    dev = c2.device
    col_ix = torch.arange(band, dtype=_I32, device=dev)[None, :]
    b_shift = _shift_in(c2, torch.full((c2.shape[0], 1), -1, dtype=_I32,
                                       device=dev))
    col_valid = (col_ix >= 1) & (b_shift >= 0)
    b_code = torch.clamp(b_shift, min=0)
    planes = _planes(sub4, b_code, col_valid)
    c_first = torch.where(col_ix == 0, 0, -gap_oe - (col_ix - 1) * gap_e)
    c_first = torch.where(c_first >= -y_drop, c_first, NEG_INF_I32)
    c_first = torch.where(col_valid | (col_ix == 0), c_first, NEG_INF_I32)
    return col_ix, col_valid, b_code, planes, c_first


def _insertions(t, gap_oe, gap_e, decay):
    """I of a row: the decayed exclusive prefix max of t, with
    NEG_INF_I32 inside the max (the kernels' Hillis-Steele scan pads
    with it, and its window reaches every column before the last)."""
    g = t - gap_oe + decay
    g_max = torch.cummax(g, dim=1).values
    g_shift = _shift_in(torch.clamp(g_max, min=NEG_INF_I32),
                        _neg(t, (t.shape[0], 1)))
    return g_shift - decay + gap_e


def ydrop_band_plain(codes1, codes2, sub4, params, band: int = 512,
                     max_rows: int = 1024, live_span: bool = False):
    """K3b's function in plain PyTorch: one DP row per step, pruned
    against each column's own running best.  With live_span, returns
    (out, (B,) int64 live-span cells)."""
    c1 = codes1.to(_I32)
    c2 = codes2.to(_I32)
    B = c1.shape[0]
    dev = c1.device
    gap_e, gap_oe, y_drop = (v.to(dev) for v in _scalars(params))
    col_ix, col_valid, _, planes, c_prev = _row_sweep_setup(
        c2, sub4, gap_e, gap_oe, y_drop, band)
    d_prev = _neg(c1, (B, band))
    decay = col_ix * gap_e
    neg1 = _neg(c1, (B, 1))
    best = torch.zeros((B, band), dtype=_I32, device=dev)
    row_of_best = torch.zeros((B, band), dtype=_I32, device=dev)
    lo = torch.full((B, max_rows), band, dtype=_I32, device=dev)
    hi = torch.full((B, max_rows), -1, dtype=_I32, device=dev)
    for row in range(max_rows):
        a = c1[:, row: row + 1]
        s = torch.where(a >= 0, _pick(planes, a), NEG_INF_I32 // 2)
        d_cur = torch.maximum(d_prev - gap_e, c_prev - gap_oe)
        t = torch.maximum(_shift_in(c_prev, neg1) + s, d_cur)
        c_cur = torch.maximum(t, _insertions(t, gap_oe, gap_e, decay))
        keep = (c_cur >= best - y_drop) & col_valid
        if live_span:
            live = keep & (a >= 0)
            lo[:, row] = torch.where(live, col_ix, band).amin(dim=1)
            hi[:, row] = torch.where(live, col_ix, -1).amax(dim=1)
        c_cur = torch.where(keep, c_cur, NEG_INF_I32)
        improved = c_cur >= best
        best = torch.where(improved, c_cur, best)
        row_of_best = torch.where(improved, row, row_of_best)
        c_prev, d_prev = c_cur, d_cur

    top = best.max(dim=1, keepdim=True).values
    at_max = best == top
    end_row = torch.where(at_max, row_of_best, -1).max(dim=1,
                                                       keepdim=True).values
    end_col = torch.where(at_max & (row_of_best == end_row), col_ix,
                          -1).max(dim=1).values
    out = _out(top[:, 0], torch.clamp(end_row[:, 0], min=0),
               torch.clamp(end_col, min=0))
    return (out, _span(lo.long(), hi.long())) if live_span else out


def ydrop_extend_batch_xla(codes1, codes2, sub4, params, band: int = 512,
                           max_rows: int = 1024):
    """The row sweep of lastz_tpu's ydrop_extend_batch_xla: per-anchor
    gaps and y-drop from params[:, :3], the prune against the anchor's
    single running best, and the row's last column at its maximum."""
    c1 = codes1.to(_I32)
    c2 = codes2.to(_I32)
    B = c1.shape[0]
    dev = c1.device
    p = params.to(_I32).to(dev)
    gap_e, gap_oe, y_drop = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    col_ix, col_valid, b_code, _, c_prev = _row_sweep_setup(
        c2, sub4, gap_e, gap_oe, y_drop, band)
    d_prev = _neg(c1, (B, band))
    decay = col_ix * gap_e
    neg1 = _neg(c1, (B, 1))
    sub = sub4.to(_I32).reshape(16).to(dev)
    b_ix = torch.clamp(b_code, max=3).to(torch.int64)
    best = torch.zeros((B, 1), dtype=_I32, device=dev)
    end_row = torch.zeros((B, 1), dtype=_I32, device=dev)
    end_col = torch.zeros((B, 1), dtype=_I32, device=dev)
    for row in range(max_rows):
        a = c1[:, row: row + 1]
        # sub_flat[max(a, 0) * 4 + b]: a gather, whose out-of-range
        # indices XLA clamps
        ix = torch.clamp(torch.clamp(a, min=0).to(torch.int64) * 4 + b_ix,
                         max=15)
        s = torch.where(col_valid & (a >= 0), sub[ix], NEG_INF_I32 // 2)
        d_cur = torch.maximum(d_prev - gap_e, c_prev - gap_oe)
        t = torch.maximum(_shift_in(c_prev, neg1) + s, d_cur)
        c_cur = torch.maximum(t, _insertions(t, gap_oe, gap_e, decay))
        c_cur = torch.where(c_cur >= best - y_drop, c_cur, NEG_INF_I32)
        c_cur = torch.where(col_valid, c_cur, NEG_INF_I32)
        row_best = c_cur.max(dim=1, keepdim=True).values
        row_arg = torch.where(c_cur == row_best, col_ix, -1).max(
            dim=1, keepdim=True).values
        improved = row_best >= best
        best = torch.where(improved, row_best, best)
        end_row = torch.where(improved, row, end_row)
        end_col = torch.where(improved, row_arg, end_col)
        c_prev, d_prev = c_cur, d_cur
    return _out(best[:, 0], end_row[:, 0], end_col[:, 0])


def _launch(name, codes1, codes2, sub4, params, band, max_rows):
    """Check the inputs of a CUDA launch and run it; returns (B, 128)."""
    dev = codes1.device
    B = codes1.shape[0]
    for what, t, shape in (("codes1", codes1, (B, max_rows)),
                           ("codes2", codes2, (B, band)),
                           ("sub4", sub4, (4, 4)), ("params", params, (B, 4))):
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, not {dev}")
        if t.dtype != _I32:
            raise ValueError(f"{name}: {what} must be int32, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if band % 32 or not 32 <= band <= 1024 or max_rows < 1 or B < 1:
        raise ValueError(f"{name}: band must be a multiple of 32 in "
                         f"[32, 1024], max_rows and the batch positive")
    out = torch.empty((B, 128), dtype=_I32, device=dev)
    rc = getattr(build.load(), name)(
        codes1.data_ptr(), codes2.data_ptr(), sub4.data_ptr(),
        params.data_ptr(), out.data_ptr(), B, band, max_rows,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, name)
    return out


def ydrop_extend_batch(codes1, codes2, sub4, params, band: int = 512,
                       max_rows: int = 1024):
    """Extend a batch of anchors one way with K3 (contract of
    lastz_tpu's ydrop_extend_batch): codes1 (B, max_rows) and codes2
    (B, band) int32 codes, -1 past the end; sub4 (4, 4); params (B, 4)
    [gap_e, gap_oe, y_drop, n_cols], of which only row 0's first three
    are read.  Returns (B, 128) int32 [best, end_row, end_col, 0...]."""
    if codes1.device.type == "cpu":
        return ydrop_wavefront_plain(codes1, codes2, sub4, params,
                                     band=band, max_rows=max_rows)
    if codes1.device.type != "cuda":
        raise ValueError(f"ydrop_extend_batch: unsupported device "
                         f"{codes1.device}")
    out = _launch("ydrop_wavefront_launch", codes1, codes2, sub4, params,
                  band, max_rows)
    ydrop_extend_batch.launches += 1
    return out


ydrop_extend_batch.launches = 0


def ydrop_band_batch(codes1, codes2, sub4, params, band: int = 512,
                     max_rows: int = 1024):
    """ydrop_extend_batch's contract, computed by K3b (the row sweep);
    its end row is the kernel row itself, not r - 1."""
    if codes1.device.type == "cpu":
        return ydrop_band_plain(codes1, codes2, sub4, params, band=band,
                                max_rows=max_rows)
    if codes1.device.type != "cuda":
        raise ValueError(f"ydrop_band_batch: unsupported device "
                         f"{codes1.device}")
    out = _launch("ydrop_band_launch", codes1, codes2, sub4, params, band,
                  max_rows)
    ydrop_band_batch.launches += 1
    return out


ydrop_band_batch.launches = 0


def prepare_anchor_batch(v1_codes, v2_codes, anchors, gap_e, gap_oe, y_drop,
                         band=512, max_rows=1024, reversed_=False):
    """Host-side gather of per-anchor code slices for the batch kernel.

    v1_codes/v2_codes: int8/int32 2-bit codes (-1 for invalid) of the
    full sequences.  anchors: list of (anchor1, anchor2) points.
    """
    B = len(anchors)
    codes1 = np.full((B, max_rows), -1, dtype=np.int32)
    codes2 = np.full((B, band), -1, dtype=np.int32)
    params = np.zeros((B, 4), dtype=np.int32)
    n1 = len(v1_codes)
    n2 = len(v2_codes)
    for k, (a1, a2) in enumerate(anchors):
        if not reversed_:
            r1 = v1_codes[a1 + 1 : min(a1 + 1 + max_rows, n1)]
            r2 = v2_codes[a2 + 1 : min(a2 + 1 + band - 1, n2)]
        else:
            r1 = v1_codes[max(0, a1 + 1 - max_rows) : a1 + 1][::-1]
            r2 = v2_codes[max(0, a2 + 1 - (band - 1)) : a2 + 1][::-1]
        codes1[k, : len(r1)] = r1
        codes2[k, : len(r2)] = r2
        params[k] = (gap_e, gap_oe, y_drop, min(len(r2), band - 1))
    return codes1, codes2, params
