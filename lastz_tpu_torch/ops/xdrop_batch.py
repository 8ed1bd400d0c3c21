"""Batched gap-free x-drop extension (reference
xdrop_extend_seed_hit, seed_search.c:2528-2801).

Extends many seed hits at once: each hit scans left then right along
its diagonal accumulating substitution scores, stopping when the
running score drops more than xDrop below the running maximum.  The
scans are UNBLOCKED (old diagonal extent = 0); the replay layer
(search/batched.py) detects the rare hits whose left scan would have
been cut by the diagonal-hash block and recomputes those exactly.

Semantics mirror the host engine's vectorized scan
(search/engine.py:_xdrop_extend) cell for cell:
  * consumed = index of the first cell whose cumulative score falls
    below max(runmax, 0) - xDrop, plus one (the failing cell is
    consumed), capped at the scan length;
  * best = max cumulative score over the consumed prefix; the end
    offset is the FIRST cell attaining it; best <= 0 reports a zero
    extension.

Two interchangeable host backends, the native C++ scan
(native/ydrop_row.cpp) and numpy, whose scans longer than a chunk carry
(cumulative score, running max, best) across chunks; and the device
one, batch_xdrop_device, the counterpart of lastz_tpu's batch_xdrop_jax
(lastz_tpu/ops/xdrop_batch.py:309): K2 (ops/xdrop_cuda.xdrop_scan) on
the card, its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np

CHUNK = 1024


def _np_scan(seq1, seq2, sub, p1, p2, n, step):
    """Vectorized chunked scan for a batch of hits (numpy backend).

    p1/p2: (H,) first cell coordinates; n: (H,) scan lengths;
    step: +1 (right) or -1 (left).  seq1/seq2 are COMPACT-alphabet
    codes and sub a (K*K,) flat int32 table when _np_scan.flat is set
    (cache-resident lookups); otherwise raw bytes + (256,256) table.
    Returns consumed, best, kbest (offsets; kbest = -1 if best <= 0).
    """
    H = len(p1)
    flatK = getattr(_np_scan, "flatK", 0)
    cdtype = np.int32 if flatK else sub.dtype
    consumed = np.zeros(H, dtype=np.int64)
    best = np.zeros(H, dtype=cdtype)
    kbest = np.full(H, -1, dtype=np.int64)
    cum = np.zeros(H, dtype=cdtype)
    runmax = np.zeros(H, dtype=cdtype)
    live = n > 0
    base = np.zeros(H, dtype=np.int64)  # cells consumed so far
    x_drop = _np_scan.x_drop
    L1, L2 = len(seq1), len(seq2)
    HBLOCK = 1 << 15  # hits per pass (bounds the (H, chunk) temps)
    FIRST = 96        # first-chunk size; most scans die inside it
    while live.any():
        idx = np.nonzero(live)[0][:HBLOCK]
        chunk = FIRST if base[idx].max() == 0 else CHUNK
        offs = np.arange(chunk, dtype=np.int64)
        i1 = p1[idx, None] + step * (base[idx, None] + offs[None, :])
        i2 = p2[idx, None] + step * (base[idx, None] + offs[None, :])
        rem = n[idx] - base[idx]
        valid = offs[None, :] < rem[:, None]
        if flatK:
            key = seq1[np.clip(i1, 0, L1 - 1)].astype(np.int16)
            key *= flatK
            key += seq2[np.clip(i2, 0, L2 - 1)]
            sc = sub[key]
        else:
            sc = sub[seq1[np.clip(i1, 0, L1 - 1)],
                     seq2[np.clip(i2, 0, L2 - 1)]]
        sc = np.where(valid, sc, 0)
        c = cum[idx, None] + np.cumsum(sc, axis=1)
        m = np.maximum(np.maximum.accumulate(c, axis=1),
                       runmax[idx, None])
        bad = (c < np.maximum(m, 0) - x_drop) & valid
        any_bad = bad.any(axis=1)
        first_bad = np.where(any_bad, bad.argmax(axis=1), chunk)
        take = np.minimum(first_bad + 1, rem)
        take = np.minimum(take, chunk)
        # best over the taken prefix (first occurrence wins, strict >)
        inpref = offs[None, :] < take[:, None]
        cc = np.where(inpref, c, np.iinfo(cdtype).min
                      if np.issubdtype(cdtype, np.integer) else -np.inf)
        chunk_best = cc.max(axis=1)
        chunk_arg = cc.argmax(axis=1)
        better = chunk_best > best[idx]
        best[idx] = np.where(better, chunk_best, best[idx])
        kbest[idx] = np.where(better, base[idx] + chunk_arg, kbest[idx])
        consumed[idx] = base[idx] + take
        # continue hits that neither failed nor exhausted their length
        cont = (~any_bad) & (rem > chunk)
        cum[idx] = c[np.arange(len(idx)), np.maximum(take - 1, 0)]
        runmax[idx] = m[np.arange(len(idx)), np.maximum(take - 1, 0)]
        base[idx] += chunk
        live[idx] = cont
    kbest = np.where(best > 0, kbest, -1)
    return consumed, best, kbest


def batch_xdrop_native(seq1, seq2, sub, pos1, pos2, x_drop, lib):
    """batch_xdrop_np semantics via one native call per hit chunk
    (native/ydrop_row.cpp xdrop_scan_batch) — the per-hit scans die
    after a few dozen bases, which a scalar C loop handles at memory
    speed while the numpy scan pays multi-pass array overheads."""
    import ctypes
    seq1 = np.ascontiguousarray(seq1, dtype=np.uint8)
    seq2 = np.ascontiguousarray(seq2, dtype=np.uint8)
    sub = np.ascontiguousarray(sub, dtype=np.int64)
    pos1 = np.ascontiguousarray(pos1, dtype=np.int64)
    pos2 = np.ascontiguousarray(pos2, dtype=np.int64)
    H = len(pos1)
    out = {k: np.empty(H, np.int64)
           for k in ("left_consumed", "left_score", "left_start",
                     "right_consumed", "right_score", "right_stop")}
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.xdrop_scan_batch(
        seq1.ctypes.data_as(p_u8), seq2.ctypes.data_as(p_u8),
        sub.ctypes.data_as(p_i64),
        ctypes.c_int64(len(seq1)), ctypes.c_int64(len(seq2)),
        ctypes.c_int64(x_drop),
        pos1.ctypes.data_as(p_i64), pos2.ctypes.data_as(p_i64),
        ctypes.c_int64(H),
        out["left_consumed"].ctypes.data_as(p_i64),
        out["left_score"].ctypes.data_as(p_i64),
        out["left_start"].ctypes.data_as(p_i64),
        out["right_consumed"].ctypes.data_as(p_i64),
        out["right_score"].ctypes.data_as(p_i64),
        out["right_stop"].ctypes.data_as(p_i64))
    return out


def batch_xdrop_np(seq1, seq2, sub, pos1, pos2, x_drop,
                   precoded=None):
    """Unblocked two-sided x-drop extension for a hit batch (numpy).

    pos1/pos2: (H,) hit END positions (origin-0 exclusive).
    precoded: optional (s1_small, s2_small, subflat, K) compact-
    alphabet arrays (int8 codes + flat (K*K,) int32 score table) —
    score lookups then hit a cache-resident table and the cumulative
    arithmetic runs in int32 (values are identical: the reference
    computes 32-bit scores).
    Returns dict of per-hit arrays:
      left_consumed, left_score, left_start,
      right_consumed (== right_block - pos1), right_score, right_stop.
    """
    pos1 = np.asarray(pos1, dtype=np.int64)
    pos2 = np.asarray(pos2, dtype=np.int64)
    if precoded is not None:
        seq1, seq2, sub, K = precoded
        _np_scan.flatK = K
    else:
        _np_scan.flatK = 0
    diag = pos1 - pos2
    # left: from pos1-1 down to stop1 = max(diag, 0)
    stop1 = np.maximum(diag, 0)
    n_left = pos1 - stop1
    _np_scan.x_drop = x_drop
    lc, lb, lk = _np_scan(seq1, seq2, sub, pos1 - 1, pos2 - 1,
                          n_left, -1)
    left_score = np.where(lb > 0, lb, 0)
    left_start = np.where(lb > 0, pos1 - 1 - lk, pos1)
    # right: from pos1 to stop1r = min(len1, len2 + diag)
    stop1r = np.minimum(len(seq1), len(seq2) + diag)
    n_right = np.maximum(stop1r - pos1, 0)
    rc, rb, rk = _np_scan(seq1, seq2, sub, pos1, pos2, n_right, +1)
    right_score = np.where(rb > 0, rb, 0)
    right_stop = np.where(rb > 0, pos1 + rk + 1, pos1)
    return dict(
        left_consumed=lc, left_score=left_score, left_start=left_start,
        right_consumed=rc, right_score=right_score,
        right_stop=right_stop)


def device_codes(seq1, seq2, sub, device):
    """The compact alphabet of the two sequences, up to 256 codes, on
    `device`: (seq1p, seq2p, subflat, K), the codes SEQ_PAD-padded as
    device.carry_state pads them (int8 for K <= 16, uint8 past it) and
    the K x K int32 table flat (16 x 16 for K <= 16, K2's narrow
    table).  The uploads are cached by content (device.upload_codes)."""
    import torch

    from ..device import SEQ_PAD, upload_codes
    from .ydrop_exact import make_compact_alphabet
    code_map, subsmall = make_compact_alphabet([seq1, seq2], sub, max_k=256)
    K = max(int(code_map.max()) + 1, 16)
    dtype = np.int8 if K == 16 else np.uint8
    subflat = torch.from_numpy(
        np.ascontiguousarray(subsmall[:K, :K]).reshape(-1)).to(device)
    return (upload_codes(seq1, code_map, device, SEQ_PAD, dtype),
            upload_codes(seq2, code_map, device, SEQ_PAD, dtype), subflat, K)


def batch_xdrop_device(seq1, seq2, sub, pos1, pos2, x_drop, device,
                       codes=None):
    """batch_xdrop_np's two-sided unblocked x-drop of every hit, both
    sides in one call of K2 on `device` (its plain version for the
    CPU), with the int32 sums of lastz_tpu's batch_xdrop_jax.  pos1/pos2
    are the hits' end positions; `codes` is device_codes' result for
    these sequences (made here when None).  The results are int64 numpy
    arrays in hit order: left_consumed, left_score, left_start,
    right_consumed, right_score, right_stop."""
    import torch

    from .xdrop_cuda import xdrop_scan
    pos1 = np.asarray(pos1, dtype=np.int64)
    pos2 = np.asarray(pos2, dtype=np.int64)
    diag = pos1 - pos2
    n_l = pos1 - np.maximum(diag, 0)
    n_r = np.maximum(np.minimum(len(seq1), len(seq2) + diag) - pos1, 0)
    s1p, s2p, subflat, K = codes or device_codes(seq1, seq2, sub, device)

    def up(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    left, right = xdrop_scan(s1p, s2p, subflat, K, up(pos1), up(pos2),
                             up(n_l), up(n_r), int(x_drop))
    lc, lb, lk, rc, rb, rk = torch.stack(
        [*left, *right]).cpu().numpy().astype(np.int64)
    return dict(
        left_consumed=lc, left_score=np.where(lb > 0, lb, 0),
        left_start=np.where(lb > 0, pos1 - 1 - lk, pos1),
        right_consumed=rc, right_score=np.where(rb > 0, rb, 0),
        right_stop=np.where(rb > 0, pos1 + rk + 1, pos1))
