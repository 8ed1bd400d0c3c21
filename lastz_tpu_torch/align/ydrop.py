"""Y-drop gapped extension — exact host engine.

Faithful re-implementation of the reference's gapped stage
(gapped_extend.c): anchors are reduced to peak points, processed in
decreasing HSP-score order, and each surviving anchor is extended in
both directions by a banded 3-state affine-gap DP ("y-drop"), bounded
left/right by previously accepted alignments and masked against their
"active segments" so no two alignments intersect.

All the semantics that are observable in golden outputs are preserved:
  * tie-breaking (D preferred over I when improving C; best-score ties
    move the alignment end; gap-extend bits preferred in traceback),
  * the exact prune/bound bookkeeping (notes 5-14 of
    gapped_extend.c:2770-2960), including the L/R bound swap for the
    reversed pass,
  * first-row seeding and the insertion "row prolongation",
  * the traceback-memory budget (alignments are truncated with a
    warning when the arena would overflow, lastz.c default 80 MB),
  * trivial self-alignment injection and removal.

This module is the correctness oracle; align/ydrop_device.py runs
the same recurrence batched on the GPU (csrc/ydrop_chunk.cu).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.scoring import (NEG_INFINITY_SCORE, WORST_POSSIBLE_SCORE,
                            neg_infinity_score, worst_possible_score)
from .edit_script import EditScript, Alignment
from .segments import SegmentTable

NEG_INF = NEG_INFINITY_SCORE
BEST_POSSIBLE = 0x7FFFFFFF

ANCHOR_PEAK_LEN = 31

DIAG_SEG = 0
HORZ_SEG = 1
VERT_SEG = 2

C_FROM_C = 0
C_FROM_I = 1
C_FROM_D = 2
I_EXTEND = 4
D_EXTEND = 8
CID_BITS = 3


@dataclass
class AliSeg:
    type: int
    b1: int
    b2: int
    e1: int
    e2: int
    next_seg: Optional["AliSeg"] = field(default=None, repr=False)
    prev_seg: Optional["AliSeg"] = field(default=None, repr=False)


@dataclass
class GAlign:
    pos1: int = 0
    pos2: int = 0
    end1: int = 0
    end2: int = 0
    hsp_id: int = 0
    first_seg: Optional[AliSeg] = None
    last_seg: Optional[AliSeg] = None
    align: Optional[Alignment] = None
    left_align1: Optional["GAlign"] = None
    right_align1: Optional["GAlign"] = None
    left_align2: Optional["GAlign"] = None
    right_align2: Optional["GAlign"] = None
    left_seg1: Optional[AliSeg] = None
    right_seg1: Optional[AliSeg] = None
    left_seg2: Optional[AliSeg] = None
    right_seg2: Optional[AliSeg] = None
    next: Optional["GAlign"] = None
    prev: Optional["GAlign"] = None
    # cached global-coordinate segment arrays for the native sweep
    # (segments are immutable once the alignment is accepted)
    flat_fwd: Optional[np.ndarray] = field(default=None, repr=False)
    flat_rev: Optional[np.ndarray] = field(default=None, repr=False)

    def save_seg(self, b1, b2, e1, e2):
        """reference save_seg: append a diagonal segment, inserting the
        connecting vertical/horizontal piece."""
        bp = AliSeg(DIAG_SEG, b1, b2, e1, e2)
        if self.first_seg is None:
            self.first_seg = bp
            bp.prev_seg = bp.next_seg = bp
            return
        tail = self.first_seg.prev_seg
        bq = AliSeg(
            HORZ_SEG if b1 == tail.e1 + 1 else VERT_SEG,
            tail.e1 + 1, tail.e2 + 1, b1 - 1, b2 - 1)
        self._insert_to_tail(bq)
        self._insert_to_tail(bp)

    def _insert_to_tail(self, bp: AliSeg):
        bp.prev_seg = self.first_seg.prev_seg
        bp.next_seg = self.first_seg
        self.first_seg.prev_seg.next_seg = bp
        self.first_seg.prev_seg = bp


@dataclass
class ActiveSeg:
    seg: AliSeg
    x: int = 0
    last_row: int = 0
    type: int = DIAG_SEG
    filter: int = 0


class TracebackLimit(Exception):
    pass


def segment_peak(s1: np.ndarray, s2: np.ndarray, sub: np.ndarray) -> int:
    """reference segment_peak: midpoint of the best-scoring
    ANCHOR_PEAK_LEN-length window (first window wins ties only when
    better, i.e. strict improvement moves the peak)."""
    seg_length = len(s1)
    if seg_length <= ANCHOR_PEAK_LEN:
        return seg_length // 2
    scores = sub[s1, s2]
    window = np.convolve(scores, np.ones(ANCHOR_PEAK_LEN, dtype=np.int64),
                         "valid") if False else None
    # exact running-sum loop semantics (strict improvement)
    csum = np.cumsum(scores)
    win = csum[ANCHOR_PEAK_LEN - 1 :].copy()
    win[1:] -= csum[: seg_length - ANCHOR_PEAK_LEN]
    best_ix = int(np.argmax(win))  # first occurrence of max == strict rule
    if best_ix == 0:
        return ANCHOR_PEAK_LEN // 2
    return best_ix + ANCHOR_PEAK_LEN - 1 - (ANCHOR_PEAK_LEN // 2)


def reduce_to_points(v1: np.ndarray, v2: np.ndarray, scoring, anchors):
    """reference reduce_to_points (gapped_extend.c:463)."""
    if anchors is None:
        return
    sub = scoring.sub
    for seg in anchors.segments:
        peak = segment_peak(
            v1[seg.pos1 : seg.pos1 + seg.length],
            v2[seg.pos2 : seg.pos2 + seg.length], sub)
        seg.pos1 += peak
        seg.pos2 += peak
        seg.length = 0


def signed_diff(a, b):
    return a - b


def _add_ops(script: EditScript, ops, reverse: bool):
    """Append single-step ops (list of 'S'/'I'/'D' or uint8 ndarray of
    their ASCII codes) to the script, optionally in reversed order;
    ndarrays are run-length compressed first."""
    if isinstance(ops, np.ndarray):
        a = ops[::-1] if reverse else ops
        if a.size == 0:
            return
        change = np.flatnonzero(a[1:] != a[:-1]) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [a.size]])
        for s, e in zip(starts, ends):
            script.add(chr(a[s]), int(e - s))
        return
    it = reversed(ops) if reverse else ops
    for op in it:
        script.add(op, 1)


class YDropAligner:
    """One-strand gapped extension pass over a set of anchors."""

    def __init__(self, v1, v2, scoring, y_drop, trim_to_peak,
                 traceback_mem=80 * 1024 * 1024,
                 truncation_report=True):
        self.v1 = v1
        self.v2 = v2
        self.rev1 = v1[::-1].copy()
        self.rev2 = v2[::-1].copy()
        self.sub = scoring.sub
        cast = float if scoring.sub.dtype == np.float64 else int
        self.gap_e = cast(scoring.gap_extend)
        self.gap_oe = cast(scoring.gap_open) + self.gap_e
        self.y_drop = cast(y_drop)
        self.trim_to_peak = trim_to_peak
        self.tb_len = traceback_mem  # 1 byte/cell, like the reference
        self.truncation_reported = False
        self.report_truncations = truncation_report

        # bounds context, set per anchor
        self.left_align: Optional[GAlign] = None
        self.right_align: Optional[GAlign] = None
        self.left_seg: Optional[AliSeg] = None
        self.right_seg: Optional[AliSeg] = None
        self.above_list: Optional[GAlign] = None
        self.below_list: Optional[GAlign] = None
        self.low1 = 0
        self.high1 = len(v1)
        self.low2 = 0
        self.high2 = len(v2)

    # -- one-sided DP -----------------------------------------------------

    def one_sided(self, reversed_, anchor1, anchor2, M, N):
        """reference ydrop_one_sided_align (gapped_extend.c:3388).

        Returns (score, end1, end2, traceback_ops) where traceback_ops
        is the list of ('S'|'I'|'D') single steps in traceback order.
        """
        if N <= 0 or M <= 0:
            return 0, 0, 0, []

        gap_e, gap_oe, y_drop = self.gap_e, self.gap_oe, self.y_drop
        NEG_INF = neg_infinity_score()
        cell_dtype = self.sub.dtype
        sub = self.sub

        if reversed_:
            # A[row] = seq1[anchor1+1-row], B[col] = seq2[anchor2+1-col]
            a_at = lambda row: self.v1[anchor1 + 1 - row]
            b_at = lambda col: self.v2[anchor2 + 1 - col]
        else:
            a_at = lambda row: self.v1[anchor1 + row]
            b_at = lambda col: self.v2[anchor2 + col]

        if gap_e != 0:
            y_drop_tail = int(y_drop // gap_e) + 6
        else:
            y_drop_tail = min(N + 1, 500 * 1000)

        # native row kernel (exact; see native/ydrop_row.cpp)
        native = None
        if self.sub.dtype == np.int64:
            from ..native import get_lib, RowResult
            lib = get_lib()
            if lib is not None:
                native = (lib, RowResult())

        # initial left/right constraints (relative column bounds)
        L = 0
        R = N + 1
        left_seg = self.left_seg
        right_seg = self.right_seg
        if left_seg is not None:
            L = signed_diff(left_seg.b2, anchor2)
            if left_seg.type == DIAG_SEG:
                L -= signed_diff(left_seg.b1, anchor1)
        if right_seg is not None:
            R = signed_diff(right_seg.b2, anchor2)
            if right_seg.type == DIAG_SEG:
                R -= signed_diff(right_seg.b1, anchor1)
        if reversed_:
            if left_seg is None and right_seg is not None:
                L, R = -R + 1, N + 1
            elif left_seg is not None and right_seg is None:
                L, R = 0, -L - 1
            elif left_seg is not None and right_seg is not None:
                L, R = -R + 1, -L - 1

        active: list[ActiveSeg] = []
        right_align = self.right_align
        left_align = self.left_align
        align_list = self.below_list if reversed_ else self.above_list

        # whole-extension native sweep (no per-row FFI / bookkeeping).
        # The sweep's cell values are int32 (the reference's s32 score
        # contract).  It detects itself when a single extension's score
        # approaches the int32 ceiling and returns overflow=1, in which
        # case we redo it on the int64 per-row path below — so the
        # sweep handles any sequence length (M/N are only distances to
        # the sequence ends, not work actually done).
        if native is not None and max(gap_e, gap_oe, y_drop) < (1 << 30):
            lib, _ = native
            if hasattr(lib, "ydrop_sweep"):
                r = self._one_sided_native(
                    lib, reversed_, anchor1, anchor2, M, N, L, R,
                    left_seg, right_seg, left_align, right_align,
                    align_list, y_drop_tail)
                if r is not None:
                    return r

        # traceback rows: tb_row[r] + c indexes tb
        tb_row = [0]
        tb = np.zeros(min(self.tb_len, 1 << 22), dtype=np.uint8)
        tb_cap = self.tb_len

        def tb_ensure(n):
            nonlocal tb
            if n > len(tb):
                new_len = min(tb_cap, max(2 * len(tb), n))
                grown = np.zeros(new_len, dtype=np.uint8)
                grown[: len(tb)] = tb
                tb = grown

        tbp = 0

        # first row
        tb_needed = y_drop_tail
        if tb_needed > tb_cap:
            raise TracebackLimit("not enough space in trace_back array")
        tb_ensure(tb_needed + 16)

        # DP cells: CC/DD arrays indexed from current row's LY
        # (reference keeps one sweep row of dpCell)
        size0 = tb_needed + 1000
        CC = np.zeros(size0, dtype=cell_dtype)
        DD = np.zeros(size0, dtype=cell_dtype)
        MASK = np.full(size0, -1, dtype=np.int64)

        def cells_ensure(n):
            nonlocal CC, DD, MASK
            if n > len(CC):
                add = n + len(CC) // 16 + 1000 - len(CC)
                CC = np.concatenate([CC, np.zeros(add, dtype=cell_dtype)])
                DD = np.concatenate([DD, np.zeros(add, dtype=cell_dtype)])
                MASK = np.concatenate([MASK, np.full(add, -1, dtype=np.int64)])

        # -- compute first row
        dq = 0
        CC[0] = c_temp = 0
        DD[0] = -gap_oe
        c = -gap_oe
        dq = 1
        tb[tbp] = 0
        tbp += 1
        col = 1
        while col <= N and c_temp >= -y_drop:
            cells_ensure(dq + 1)
            CC[dq] = c_temp = c
            DD[dq] = c - gap_oe
            dq += 1
            c -= gap_e
            tb_ensure(tbp + 1)
            tb[tbp] = C_FROM_I
            tbp += 1
            col += 1

        LY = 0
        RY = col  # one beyond feasible

        end1 = end2 = 0
        best_score = 0
        boundary_score = NEG_INF
        end_is_boundary = False

        row = 1
        while row <= M:
            prev_LY = LY
            (L, R, LY, RY, left_seg, right_seg, left_align, right_align) = \
                self._update_lr_bounds(
                    reversed_, right_seg, left_seg, right_align, left_align,
                    row, anchor1, anchor2, L, R, LY, RY)
            cells_ensure((RY - prev_LY) + y_drop_tail + 2)
            active, align_list = self._update_active_segs(
                reversed_, active, align_list, MASK, prev_LY,
                row, anchor1, anchor2, LY, RY)

            if RY < LY:
                RY = LY
            tb_needed = RY - LY + y_drop_tail
            if tb_needed < 0:
                tb_needed = 0
            if tbp + tb_needed >= tb_cap:
                if not self.report_truncations:
                    break  # --notruncationreport (lastz.c:7815)
                if not reversed_:
                    sys.stderr.write(
                        f"truncating alignment ending at ({end1 + anchor1 + 1}"
                        f",{end2 + anchor2 + 1});")
                else:
                    sys.stderr.write(
                        f"truncating alignment starting at ({anchor1 + 2 - end1}"
                        f",{anchor2 + 2 - end2});")
                sys.stderr.write(f"  anchor at ({anchor1},{anchor2})\n")
                if not self.truncation_reported:
                    self.truncation_reported = True
                    sys.stderr.write(
                        "truncation can be reduced by increasing traceback memory\n")
                break
            if row >= len(tb_row):
                tb_row.extend([0] * (row + 1 - len(tb_row)))
            tb_row[row] = tbp - LY
            tb_ensure(tbp + tb_needed + 16)

            cells_ensure(tb_needed + (LY - prev_LY) + 2)
            # dq index 0 <-> col LY (current row); dp reads previous row:
            # cell for col is at index col - prev_LY
            shift = LY - prev_LY

            a_char = a_at(row)
            sub_row = sub[a_char]

            if native is not None:
                import ctypes
                lib, res = native
                if reversed_:
                    b_origin, b_step = anchor2 + 1, -1
                else:
                    b_origin, b_step = anchor2, 1
                p_i64 = ctypes.POINTER(ctypes.c_int64)
                p_u8 = ctypes.POINTER(ctypes.c_uint8)
                lib.ydrop_row(
                    CC.ctypes.data_as(p_i64),
                    DD.ctypes.data_as(p_i64),
                    MASK.ctypes.data_as(p_i64),
                    tb.ctypes.data_as(p_u8),
                    sub_row.ctypes.data_as(p_i64),
                    self.v2.ctypes.data_as(p_u8),
                    b_origin, b_step,
                    row, M, N, LY, RY, prev_LY,
                    gap_e, gap_oe, y_drop, NEG_INF,
                    best_score, end1, end2,
                    1 if end_is_boundary else 0, boundary_score,
                    1 if self.trim_to_peak else 0,
                    1 if active else 0,
                    tbp, ctypes.byref(res))
                LY = res.LY
                np_col = res.np_col
                i_val = res.i_val
                best_score = res.best_score
                end1, end2 = res.end1, res.end2
                end_is_boundary = bool(res.end_is_boundary)
                boundary_score = res.boundary_score
                dq = res.dq
                tbp = res.tbp
                col = min(RY, N + 1)
                if LY >= RY:
                    break
                NN = (R - 1) if (right_seg is not None and R > 0) else N
                if RY > np_col + 1:
                    RY = np_col + 1
                else:
                    while i_val >= best_score - y_drop and RY <= NN:
                        cells_ensure(dq + 1)
                        CC[dq] = i_val
                        DD[dq] = i_val - gap_oe
                        dq += 1
                        i_val -= gap_e
                        tb_ensure(tbp + 1)
                        tb[tbp] = C_FROM_I
                        tbp += 1
                        RY += 1
                if RY <= NN:
                    cells_ensure(dq + 1)
                    DD[dq] = NEG_INF
                    CC[dq] = NEG_INF
                    RY += 1
                row += 1
                continue

            col = LY
            np_col = col
            i_val = NEG_INF
            c = NEG_INF
            dp = shift  # read index for col (== col - prev_LY)
            dq = 0  # write index for col (== col - LY)

            # local bindings for speed
            CC_l, DD_l, MASK_l = CC, DD, MASK

            while col < RY and col <= N:
                d = DD_l[dp]
                masked = MASK_l[dp] == row and len(active) > 0

                if masked:
                    # prune (mask): refuse this cell
                    if col + 1 <= N:
                        c = CC_l[dp] + sub_row[b_at(col + 1)]
                    else:
                        c = NEG_INF
                    if col == LY:
                        LY += 1
                    else:
                        i_val = NEG_INF
                        DD_l[dq] = NEG_INF
                        CC_l[dq] = NEG_INF
                        dq += 1
                    dp += 1
                    tb[tbp] = 0
                    tbp += 1
                    col += 1
                    continue

                if d > c or i_val > c:
                    # we CAN improve C
                    if d >= i_val:
                        c = d
                        link = C_FROM_D | I_EXTEND | D_EXTEND
                    else:
                        c = i_val
                        link = C_FROM_I | I_EXTEND | D_EXTEND
                    if c < best_score - y_drop:
                        if col + 1 <= N:
                            c = CC_l[dp] + sub_row[b_at(col + 1)]
                        else:
                            c = NEG_INF
                        if col == LY:
                            LY += 1
                        else:
                            i_val = NEG_INF
                            DD_l[dq] = NEG_INF
                            CC_l[dq] = NEG_INF
                            dq += 1
                        dp += 1
                        tb[tbp] = 0
                        tbp += 1
                        col += 1
                        continue
                    i_val -= gap_e
                    DD_l[dq] = d - gap_e
                else:
                    # we CANNOT improve C
                    if c < best_score - y_drop:
                        if col + 1 <= N:
                            c = CC_l[dp] + sub_row[b_at(col + 1)]
                        else:
                            c = NEG_INF
                        if col == LY:
                            LY += 1
                        else:
                            i_val = NEG_INF
                            DD_l[dq] = NEG_INF
                            CC_l[dq] = NEG_INF
                            dq += 1
                        dp += 1
                        tb[tbp] = 0
                        tbp += 1
                        col += 1
                        continue
                    if c >= best_score:
                        best_score = c
                        end1, end2 = row, col
                        end_is_boundary = False
                    if (not self.trim_to_peak and c >= boundary_score
                            and (row == M or col == N)):
                        boundary_score = c
                        end1, end2 = row, col
                        end_is_boundary = True
                    c_open = c - gap_oe
                    d -= gap_e
                    if c_open > d:
                        DD_l[dq] = c_open
                        link = C_FROM_C
                    else:
                        DD_l[dq] = d
                        link = C_FROM_C | D_EXTEND
                    i_val -= gap_e
                    if c_open > i_val:
                        i_val = c_open
                    else:
                        link |= I_EXTEND

                np_col = col
                if col + 1 <= N:
                    c_next = CC_l[dp] + sub_row[b_at(col + 1)]
                else:
                    c_next = NEG_INF
                dp += 1
                CC_l[dq] = c
                dq += 1
                c = c_next
                tb[tbp] = link
                tbp += 1
                col += 1

            if LY >= RY:
                break

            NN = (R - 1) if (right_seg is not None and R > 0) else N

            if RY > np_col + 1:
                RY = np_col + 1
            else:
                # row prolongation with insertions
                while i_val >= best_score - y_drop and RY <= NN:
                    cells_ensure(dq + 1)
                    CC_l[dq] = i_val
                    DD_l[dq] = i_val - gap_oe
                    dq += 1
                    i_val -= gap_e
                    tb_ensure(tbp + 1)
                    tb[tbp] = C_FROM_I
                    tbp += 1
                    RY += 1

            if RY <= NN:
                cells_ensure(dq + 1)
                DD_l[dq] = NEG_INF
                CC_l[dq] = NEG_INF
                RY += 1

            row += 1

        # traceback
        row, col = end1, end2
        ops = []
        prev_op = 0
        while row >= 1 or col > 0:
            link = tb[tb_row[row] + col]
            op = link & CID_BITS
            if prev_op == C_FROM_I and (link & I_EXTEND):
                op = C_FROM_I
            if prev_op == C_FROM_D and (link & D_EXTEND):
                op = C_FROM_D
            if op == C_FROM_I:
                col -= 1
                ops.append("I")
            elif op == C_FROM_D:
                row -= 1
                ops.append("D")
            else:
                row -= 1
                col -= 1
                ops.append("S")
            prev_op = op

        if end_is_boundary:
            return boundary_score, end1, end2, ops
        return best_score, end1, end2, ops

    # -- native whole-extension sweep ---------------------------------------

    def _flatten_bound(self, seg, align, init, last_row_of, advance,
                       delta, M, anchor1, anchor2):
        """Pre-walk one side's _update_lr_bounds transitions into
        piecewise-linear records (from_row, to_row, base, slope): the
        bound at row r in [from_row, to_row] is base+slope*(r-from_row);
        uncovered rows have no bound.  Walk cost is O(#segments
        visited), not O(rows)."""
        recs = []
        val = init
        row = 1
        while row <= M and seg is not None:
            lr = last_row_of(seg)
            if lr >= row:
                slope = 1 if seg.type == DIAG_SEG else 0
                r_end = min(lr, M)
                recs.append((row, r_end, val + slope, slope))
                val += slope * (r_end - row + 1)
                row = r_end + 1
            else:
                val, seg, align = advance(seg, align, row, anchor1,
                                          anchor2)
                val += delta
                if seg is None:
                    break
                recs.append((row, row, val, 0))
                row += 1
        if not recs:
            return np.zeros((1, 4), np.int64), 0
        return np.asarray(recs, np.int64), len(recs)

    @staticmethod
    def _flat_segs(mp: GAlign, reversed_) -> np.ndarray:
        """(n, 5) global-coordinate segment rows (type, b1, b2, e1, e2)
        in sweep traversal order, cached on the alignment."""
        cached = mp.flat_rev if reversed_ else mp.flat_fwd
        if cached is not None:
            return cached
        rows = []
        bp = mp.last_seg if reversed_ else mp.first_seg
        while bp is not None:
            rows.append((bp.type, bp.b1, bp.b2, bp.e1, bp.e2))
            bp = bp.prev_seg if reversed_ else bp.next_seg
        arr = np.asarray(rows, np.int64).reshape(len(rows), 5)
        if reversed_:
            mp.flat_rev = arr
        else:
            mp.flat_fwd = arr
        return arr

    def _flatten_actives(self, reversed_, align_list, anchor1, anchor2,
                         M):
        """Marshal the sweep's align_list walk (update_active_segs
        activation order) into arrays for the native sweep."""
        act_rows = []
        parts = []
        mp = align_list
        while mp is not None:
            r = (anchor1 - mp.end1) if reversed_ else (mp.pos1 - anchor1)
            if r > M:
                break
            act_rows.append(r)
            parts.append(self._flat_segs(mp, reversed_))
            mp = mp.prev if reversed_ else mp.next
        if not act_rows:
            z = np.zeros(1, np.int64)
            return z, z, z, 0, np.zeros((1, 4), np.int64)
        cnt = np.asarray([p.shape[0] for p in parts], np.int64)
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        g = np.concatenate(parts)  # (total, 5) type,b1,b2,e1,e2
        segs = np.empty((g.shape[0], 4), np.int64)
        segs[:, 0] = g[:, 0]
        if reversed_:
            segs[:, 1] = anchor2 - g[:, 4]   # x
            segs[:, 2] = anchor1 - g[:, 1]   # last_row
            segs[:, 3] = anchor2 - g[:, 2]   # horz_end
        else:
            segs[:, 1] = g[:, 2] - anchor2
            segs[:, 2] = g[:, 3] - anchor1
            segs[:, 3] = g[:, 4] - anchor2
        return (np.asarray(act_rows, np.int64), off, cnt,
                len(act_rows), segs)

    def _one_sided_native(self, lib, reversed_, anchor1, anchor2, M, N,
                          L, R, left_seg, right_seg, left_align,
                          right_align, align_list, y_drop_tail):
        import ctypes
        from ..native import SweepResult

        if y_drop_tail > self.tb_len:
            raise TracebackLimit("not enough space in trace_back array")

        def marshal(hz):
            """Bound records + actives for rows [1, hz] (lazy
            horizon: marshaling to the full M — the distance to the
            sequence END — made the accept loop O(n^2) in accepted
            alignments at 40 Mbp; rows beyond the sweep's actual
            extent are never consulted, and the caller redoes the
            call with a larger horizon when the sweep reaches hz)."""
            if reversed_:
                lrow = lambda s: anchor1 - s.b1
                ladv = lambda s, a, r, a1, a2: self._prev_sweep_seg(
                    True, s, a, r, a1, a2)
                radv = lambda s, a, r, a1, a2: self._prev_sweep_seg(
                    False, s, a, r, a1, a2)
                lrec, n_l = self._flatten_bound(
                    right_seg, right_align, L, lrow, ladv, +1, hz,
                    anchor1, anchor2)
                rrec, n_r = self._flatten_bound(
                    left_seg, left_align, R, lrow, radv, -1, hz,
                    anchor1, anchor2)
            else:
                frow = lambda s: s.e1 - anchor1
                ladv = lambda s, a, r, a1, a2: self._next_sweep_seg(
                    False, s, a, r, a1, a2)
                radv = lambda s, a, r, a1, a2: self._next_sweep_seg(
                    True, s, a, r, a1, a2)
                lrec, n_l = self._flatten_bound(
                    left_seg, left_align, L, frow, ladv, +1, hz,
                    anchor1, anchor2)
                rrec, n_r = self._flatten_bound(
                    right_seg, right_align, R, frow, radv, -1, hz,
                    anchor1, anchor2)
            acts = self._flatten_actives(reversed_, align_list,
                                         anchor1, anchor2, hz)
            return lrec, n_l, rrec, n_r, acts

        horizon = min(M, max(8192, 4 * y_drop_tail))
        (lrec, n_l, rrec, n_r,
         (act_rows, seg_off, seg_cnt, n_acts, segs)) = marshal(horizon)

        tb = getattr(self, "_tb_buf", None)
        if tb is None or tb.shape[0] < self.tb_len:
            tb = self._tb_buf = np.empty(self.tb_len, np.uint8)
        ops_cap = len(self.v1) + len(self.v2) + 4
        ops = getattr(self, "_ops_buf", None)
        if ops is None or ops.shape[0] < ops_cap:
            ops = self._ops_buf = np.empty(ops_cap, np.uint8)

        if reversed_:
            a_origin, a_step = anchor1 + 1, -1
            b_origin, b_step = anchor2 + 1, -1
        else:
            a_origin, a_step = anchor1, 1
            b_origin, b_step = anchor2, 1

        i64 = ctypes.c_int64
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        res = SweepResult()
        while True:
            lib.ydrop_sweep(
                self.v1.ctypes.data_as(p_u8),
                self.v2.ctypes.data_as(p_u8),
                self.sub.ctypes.data_as(p_i64),
                i64(a_origin), i64(a_step), i64(b_origin), i64(b_step),
                i64(M), i64(N),
                i64(self.gap_e), i64(self.gap_oe), i64(self.y_drop),
                i64(y_drop_tail), i64(neg_infinity_score()),
                i64(1 if self.trim_to_peak else 0),
                lrec.ctypes.data_as(p_i64), i64(n_l),
                rrec.ctypes.data_as(p_i64), i64(n_r),
                act_rows.ctypes.data_as(p_i64),
                seg_off.ctypes.data_as(p_i64),
                seg_cnt.ctypes.data_as(p_i64), i64(n_acts),
                segs.ctypes.data_as(p_i64),
                tb.ctypes.data_as(p_u8), i64(self.tb_len),
                ops.ctypes.data_as(p_u8),
                ctypes.byref(res))
            # lazy-horizon guard: a sweep that reached the marshaled
            # horizon could have consulted bounds/actives we did not
            # marshal — redo with a larger horizon (rare: only
            # extensions longer than the initial 8192-row window)
            if horizon >= M or int(res.n_rows) <= horizon:
                break
            horizon = min(M, horizon * 8)
            (lrec, n_l, rrec, n_r,
             (act_rows, seg_off, seg_cnt, n_acts, segs)) = \
                marshal(horizon)

        from .. import stats as _stats
        ex = _stats.current.extra
        if res.overflow:
            # int32 score headroom exhausted mid-sweep (needs a single
            # extension scoring >1e9): redo on the int64 per-row path
            ex["sweep_ovf_redo"] = ex.get("sweep_ovf_redo", 0) + 1
            return None
        ex["ydrop_cells"] = ex.get("ydrop_cells", 0) + int(res.tbp)
        if res.n_rows:  # LASTZ_TORCH_SWEEP_PROF=1 cycle buckets
            ex["sweep_rows"] = ex.get("sweep_rows", 0) + int(res.n_rows)
            for f in ("cy_srow", "cy_row", "cy_other"):
                ex[f] = ex.get(f, 0) + int(getattr(res, f))

        end1, end2 = res.end1, res.end2
        if res.truncated and self.report_truncations:
            if not reversed_:
                sys.stderr.write(
                    f"truncating alignment ending at ({end1 + anchor1 + 1}"
                    f",{end2 + anchor2 + 1});")
            else:
                sys.stderr.write(
                    f"truncating alignment starting at ({anchor1 + 2 - end1}"
                    f",{anchor2 + 2 - end2});")
            sys.stderr.write(f"  anchor at ({anchor1},{anchor2})\n")
            if not self.truncation_reported:
                self.truncation_reported = True
                sys.stderr.write(
                    "truncation can be reduced by increasing traceback memory\n")
        return res.score, end1, end2, ops[: res.n_ops].copy()

    # -- bounds maintenance --------------------------------------------------

    def _update_lr_bounds(self, reversed_, right_seg, left_seg,
                          right_align, left_align,
                          row, anchor1, anchor2, L, R, LY, RY):
        if not reversed_:
            if left_seg is not None:
                if left_seg.e1 >= row + anchor1:
                    if left_seg.type == DIAG_SEG:
                        L += 1
                else:
                    L, left_seg, left_align = self._next_sweep_seg(
                        False, left_seg, left_align, row, anchor1, anchor2)
                    L += 1
            if left_seg is not None:
                LY = max(LY, L)
            if right_seg is not None:
                if right_seg.e1 >= row + anchor1:
                    if right_seg.type == DIAG_SEG:
                        R += 1
                else:
                    R, right_seg, right_align = self._next_sweep_seg(
                        True, right_seg, right_align, row, anchor1, anchor2)
                    R -= 1
            if right_seg is not None:
                RY = _special_min(RY, R)
        else:
            if right_seg is not None:
                if right_seg.b1 <= anchor1 - row:
                    if right_seg.type == DIAG_SEG:
                        L += 1
                else:
                    L, right_seg, right_align = self._prev_sweep_seg(
                        True, right_seg, right_align, row, anchor1, anchor2)
                    L += 1
            if right_seg is not None:
                LY = max(LY, L)
            if left_seg is not None:
                if left_seg.b1 <= anchor1 - row:
                    if left_seg.type == DIAG_SEG:
                        R += 1
                else:
                    R, left_seg, left_align = self._prev_sweep_seg(
                        False, left_seg, left_align, row, anchor1, anchor2)
                    R -= 1
            if left_seg is not None:
                RY = _special_min(RY, R)
        return L, R, LY, RY, left_seg, right_seg, left_align, right_align

    def _next_sweep_seg(self, look_right, bp, mp, row, anchor1, anchor2):
        bp = bp.next_seg
        if bp is not None:
            if bp.type == HORZ_SEG:
                bp = bp.next_seg
                if bp is None:
                    raise RuntimeError("last alignment segment was horizontal")
            return signed_diff(bp.b2, anchor2), bp, mp
        if look_right:
            bp, mp = mp.right_seg2, mp.right_align2
        else:
            bp, mp = mp.left_seg2, mp.left_align2
        if bp is None:
            return 0, bp, mp
        if bp.type == DIAG_SEG:
            col = (row + signed_diff(bp.b2, anchor2)
                   - signed_diff(bp.b1, anchor1))
        else:
            col = signed_diff(bp.b2, anchor2)
        return col, bp, mp

    def _prev_sweep_seg(self, look_right, bp, mp, row, anchor1, anchor2):
        bp = bp.prev_seg
        if bp is not None:
            if bp.type == HORZ_SEG:
                bp = bp.prev_seg
                if bp is None:
                    raise RuntimeError("first alignment segment was horizontal")
            return signed_diff(anchor2, bp.e2), bp, mp
        if look_right:
            bp, mp = mp.right_seg1, mp.right_align1
        else:
            bp, mp = mp.left_seg1, mp.left_align1
        if bp is None:
            return 0, bp, mp
        if bp.type == DIAG_SEG:
            col = (row + signed_diff(anchor2, bp.e2)
                   - signed_diff(anchor1, bp.e1))
        else:
            col = signed_diff(anchor2, bp.e2)
        return col, bp, mp

    def _update_active_segs(self, reversed_, active, align_list, MASK,
                            prev_LY, row, anchor1, anchor2, LY, RY):
        # MASK is indexed like the PREVIOUS row's cells: index col - prev_LY
        for act in active:
            if act.type == HORZ_SEG:
                raise RuntimeError("impossible horizontal segment")
            if act.last_row >= row:
                if act.type == DIAG_SEG:
                    act.x += 1
                if LY <= act.x <= RY:
                    MASK[act.x - prev_LY] = row
            else:
                nxt = act.seg.prev_seg if reversed_ else act.seg.next_seg
                if nxt is not None:
                    act.seg = nxt
                    self._build_active_seg(reversed_, act, MASK, prev_LY,
                                           row, anchor1, anchor2, LY, RY)
                    if act.type == HORZ_SEG:
                        act.seg = (act.seg.prev_seg if reversed_
                                   else act.seg.next_seg)
                        self._build_active_seg(reversed_, act, MASK, prev_LY,
                                               row, anchor1, anchor2, LY, RY)
                else:
                    act.filter = 1
        if not reversed_:
            while (align_list is not None
                   and align_list.pos1 - anchor1 == row):
                act = ActiveSeg(seg=align_list.first_seg)
                self._build_active_seg(reversed_, act, MASK, prev_LY,
                                       row, anchor1, anchor2, LY, RY)
                active = [act] + active
                align_list = align_list.next
        else:
            while (align_list is not None
                   and anchor1 - align_list.end1 == row):
                act = ActiveSeg(seg=align_list.last_seg)
                self._build_active_seg(reversed_, act, MASK, prev_LY,
                                       row, anchor1, anchor2, LY, RY)
                active = [act] + active
                align_list = align_list.prev
        active = [a for a in active if a.filter == 0]
        return active, align_list

    def _build_active_seg(self, reversed_, act, MASK, prev_LY,
                          row, anchor1, anchor2, LY, RY):
        act.type = act.seg.type
        if not reversed_:
            act.x = act.seg.b2 - anchor2
            act.last_row = act.seg.e1 - anchor1
        else:
            act.x = anchor2 - act.seg.e2
            act.last_row = anchor1 - act.seg.b1
        if act.type != HORZ_SEG:
            if LY <= act.x <= RY:
                MASK[act.x - prev_LY] = row
        else:
            horz_end = (act.seg.e2 - anchor2 if not reversed_
                        else anchor2 - act.seg.b2)
            i_min = max(LY, act.x)
            i_max = min(RY, horz_end)
            for i in range(i_min, i_max + 1):
                MASK[i - prev_LY] = row

    # -- two-sided extension ---------------------------------------------------

    def ydrop_align(self, anchor1, anchor2):
        """reference ydrop_align (gapped_extend.c:2459).

        Returns (score, start1, start2, stop1, stop2, script).
        """
        score_left, e1, e2, ops_left = self.one_sided(
            True, anchor1, anchor2,
            (anchor1 + 1) - self.low1, (anchor2 + 1) - self.low2)
        start1 = anchor1 + 1 - e1
        start2 = anchor2 + 1 - e2

        score_right, e1, e2, ops_right = self.one_sided(
            False, anchor1, anchor2,
            self.high1 - (anchor1 + 1), self.high2 - (anchor2 + 1))
        stop1 = anchor1 + e1
        stop2 = anchor2 + e2

        # left traceback order == forward order; right needs reversal
        script = EditScript()
        _add_ops(script, ops_left, reverse=False)
        _add_ops(script, ops_right, reverse=True)

        s = score_left + score_right

        # lop indels from the ends (rare; rescore when it happens)
        if script.ops:
            if script.ops[0][0] != "S":
                start1, start2, s = self._lop_initial(
                    script, start1, start2)
            if script.ops and script.ops[-1][0] != "S":
                stop1, stop2, s = self._lop_final(script, start1, start2,
                                                  stop1, stop2)
        return s, start1, start2, stop1, stop2, script

    def _lop_initial(self, script, start1, start2):
        pos1, pos2 = start1, start2
        ix = 0
        while ix < len(script.ops) and script.ops[ix][0] != "S":
            op, run = script.ops[ix]
            if op == "I":
                pos2 += run
            else:
                pos1 += run
            ix += 1
        if ix == len(script.ops):
            return pos1, pos2, worst_possible_score()
        script.ops[:ix] = []
        s = self._score_alignment(pos1, pos2, script)
        return pos1, pos2, s

    def _lop_final(self, script, start1, start2, stop1, stop2):
        pos1, pos2 = stop1, stop2
        ix = len(script.ops)
        while ix > 0 and script.ops[ix - 1][0] != "S":
            op, run = script.ops[ix - 1]
            if op == "I":
                pos2 -= run
            else:
                pos1 -= run
            ix -= 1
        if ix == 0:
            return pos1, pos2, worst_possible_score()
        del script.ops[ix:]
        s = self._score_alignment(start1, start2, script)
        return pos1, pos2, s

    def _score_alignment(self, pos1, pos2, script):
        s = 0
        i, j = pos1, pos2
        for op, run in script.ops:
            if op == "S":
                s += int(self.sub[self.v1[i : i + run],
                                  self.v2[j : j + run]].sum())
                i += run
                j += run
            elif op == "I":
                s -= self.gap_oe - self.gap_e + run * self.gap_e
                j += run
            else:
                s -= self.gap_oe - self.gap_e + run * self.gap_e
                i += run
        return s


def _special_min(RY, R):
    if R <= 0:
        return 0
    return R if R < RY else RY


# -- alignment list bookkeeping (obi/oed) ------------------------------------


def msp_left_right(obi: Optional[GAlign], m: GAlign,
                   cands=None) -> bool:
    """reference msp_left_right: find bounding segments at the anchor;
    False if the anchor lies inside an existing alignment.

    `cands` is an optional pre-stabbed candidate list in obi order
    (AcceptIndex.stab) replacing the linked-list scan (O(#aligns) per
    anchor otherwise — the hot part of the bookkeeping with thousands
    of accepted alignments)."""
    pos1, pos2 = m.pos1, m.pos2
    right = left = None
    m_right = m_left = None
    b_right = b_left = None
    if cands is None:
        cands = []
        p = obi
        while p is not None and p.pos1 <= pos1:
            if p.end1 >= pos1:
                cands.append(p)
            p = p.next
    for p in cands:
        bp = p.first_seg
        while bp is not None:
            if bp.e1 >= pos1:
                break
            bp = bp.next_seg
            if bp is p.first_seg:
                bp = None
                break
        if bp is None:
            continue
        if bp.type == HORZ_SEG:
            raise RuntimeError("msp_left_right: cannot be horizontal")
        if bp.type == DIAG_SEG:
            x = signed_diff(bp.b2, pos2) + signed_diff(pos1, bp.b1)
        else:
            x = signed_diff(bp.b2, pos2)
        if x == 0:
            return False
        if x > 0 and (right is None or x < right):
            right, m_right, b_right = x, p, bp
        elif x < 0 and (left is None or -x < left):
            left, m_left, b_left = -x, p, bp
    m.right_align1 = m.right_align2 = m_right
    m.right_seg1 = m.right_seg2 = b_right
    m.left_align1 = m.left_align2 = m_left
    m.left_seg1 = m.left_seg2 = b_left
    return True


def get_above_below(aligner: YDropAligner, anchor1,
                    obi: Optional[GAlign], oed: Optional[GAlign]):
    mp = oed
    while mp is not None:
        if mp.end1 < anchor1:
            break
        mp = mp.prev
    aligner.below_list = mp
    mp = obi
    while mp is not None:
        if mp.pos1 > anchor1:
            break
        mp = mp.next
    aligner.above_list = mp


def align_left_right(obi: Optional[GAlign], m: GAlign, cands=None):
    """`cands` is an optional pre-filtered overlap candidate list in
    obi order (AcceptIndex.overlapping), replacing the full-list walk."""
    pos1, pos2 = m.pos1, m.pos2
    end1, end2 = m.end1, m.end2
    rob = rot = lob = lot = None
    m_rob = m_rot = m_lob = m_lot = None
    b_rob = b_rot = b_lob = b_lot = None
    if cands is None:
        cands = []
        p = obi
        while p is not None:
            if not (p.pos1 > end1 or p.end1 < pos1):
                cands.append(p)
            p = p.next
    for p in cands:
        bp = p.first_seg
        while bp is not None:
            if bp.type != HORZ_SEG and bp.e1 >= pos1:
                break
            bp = bp.next_seg
            if bp is p.first_seg:
                bp = None
                break
        if bp is not None and bp.b1 <= pos1:
            if bp.type == DIAG_SEG:
                x = signed_diff(bp.b2, pos2) + signed_diff(pos1, bp.b1)
            else:
                x = signed_diff(bp.b2, pos2)
            if x > 0 and (rob is None or x < rob):
                rob, m_rob, b_rob = x, p, bp
            elif x < 0 and (lob is None or -x < lob):
                lob, m_lob, b_lob = -x, p, bp
        while bp is not None:
            if bp.type != HORZ_SEG and bp.e1 >= end1:
                break
            bp = bp.next_seg
            if bp is p.first_seg:
                bp = None
                break
        if bp is not None and bp.type != HORZ_SEG and bp.e1 >= end1:
            if bp.type == DIAG_SEG:
                x = signed_diff(bp.b2, end2) + signed_diff(end1, bp.b1)
            else:
                x = signed_diff(bp.b2, end2)
            if x > 0 and (rot is None or x < rot):
                rot, m_rot, b_rot = x, p, bp
            elif x < 0 and (lot is None or -x < lot):
                lot, m_lot, b_lot = -x, p, bp
    m.right_align1, m.right_seg1 = m_rob, b_rob
    m.right_align2, m.right_seg2 = m_rot, b_rot
    m.left_align1, m.left_seg1 = m_lob, b_lob
    m.left_align2, m.left_seg2 = m_lot, b_lot


def insert_align(m: GAlign, obi, oed):
    """Insert into both ordered lists; returns new (obi, oed)."""
    mq, mp = None, obi
    while mp is not None and mp.pos1 < m.pos1:
        mq, mp = mp, mp.next
    if mq is not None:
        mq.next = m
        m.next = mp
    else:
        m.next = obi
        obi = m
    mq, mp = None, oed
    while mp is not None and mp.end1 > m.end1:
        mq, mp = mp, mp.prev
    if mq is not None:
        mq.prev = m
        m.prev = mp
    else:
        m.prev = oed
        oed = m
    return obi, oed


class AcceptIndex:
    """Incrementally-maintained index over the accepted-alignment lists
    (replaces the rebuild-per-insert snapshot that made the accept loop
    O(n^2) in accepted alignments; reference keeps plain linked lists,
    gapped_extend.c:1299-1345, whose walks are the same O(n) cost this
    removes).

    Maintains, under insert(m):
      * the obi linked list (pos1 ascending, newest-first among equal
        pos1 — byte-identical to the reference's insert_align walk) via
        `m.next`, plus `self.obi` (head);
      * the oed linked list (end1 descending, newest-first among ties)
        via `m.prev`, plus `self.oed` (head);
      * pos1/end1 bisect keys for O(log n) above/below lookups;
      * a bin grid over the target axis for O(bin) interval-stab and
        overlap queries (msp_left_right / align_left_right candidate
        sets), iterated in exact obi order via the (pos1, -seq) key;
      * a bbox bin grid for the device path's accepted-bounding-box
        point test.
    """

    BIN_SHIFT = 15  # 32 Kbp bins

    def __init__(self):
        from bisect import bisect_left, bisect_right
        self._bl, self._br = bisect_left, bisect_right
        self.obi: Optional[GAlign] = None
        self.oed: Optional[GAlign] = None
        self._obi_nodes: list[GAlign] = []   # pos1 asc, newest-first ties
        self._pos1_keys: list[int] = []
        self._oed_nodes: list[GAlign] = []   # (end1, seq) ascending
        self._end1_keys: list[int] = []
        self._bins: dict[int, list[GAlign]] = {}
        self._bbox_bins: dict[int, list[tuple]] = {}
        self._seq = 0

    # -- mutation ---------------------------------------------------------

    def insert(self, m: GAlign):
        m._accept_seq = self._seq
        self._seq += 1
        # obi: before all equal pos1 (newest-first), like the reference
        i = self._bl(self._pos1_keys, m.pos1)
        self._pos1_keys.insert(i, m.pos1)
        self._obi_nodes.insert(i, m)
        m.next = self._obi_nodes[i + 1] \
            if i + 1 < len(self._obi_nodes) else None
        if i > 0:
            self._obi_nodes[i - 1].next = m
        self.obi = self._obi_nodes[0]
        # oed: ascending (end1, seq); traversal head is the last node
        j = self._br(self._end1_keys, m.end1)
        self._end1_keys.insert(j, m.end1)
        self._oed_nodes.insert(j, m)
        m.prev = self._oed_nodes[j - 1] if j > 0 else None
        if j + 1 < len(self._oed_nodes):
            self._oed_nodes[j + 1].prev = m
        self.oed = self._oed_nodes[-1]
        # target-axis bins
        sh = self.BIN_SHIFT
        for b in range(m.pos1 >> sh, (m.end1 >> sh) + 1):
            self._bins.setdefault(b, []).append(m)

    def add_bbox(self, b1lo, b1hi, b2lo, b2hi):
        sh = self.BIN_SHIFT
        box = (b1lo, b1hi, b2lo, b2hi)
        for b in range(b1lo >> sh, (b1hi >> sh) + 1):
            self._bbox_bins.setdefault(b, []).append(box)

    # -- queries ----------------------------------------------------------

    def stab(self, pos1: int) -> list[GAlign]:
        """Alignments whose [pos1, end1] contains pos1, in obi order."""
        cands = [p for p in self._bins.get(pos1 >> self.BIN_SHIFT, ())
                 if p.pos1 <= pos1 <= p.end1]
        if len(cands) > 1:
            cands.sort(key=lambda p: (p.pos1, -p._accept_seq))
        return cands

    def overlapping(self, pos1: int, end1: int) -> list[GAlign]:
        """Alignments whose [pos1, end1] range overlaps the given one,
        in obi order (align_left_right's candidate walk)."""
        sh = self.BIN_SHIFT
        seen = set()
        cands = []
        for b in range(pos1 >> sh, (end1 >> sh) + 1):
            for p in self._bins.get(b, ()):
                k = id(p)
                if k in seen:
                    continue
                seen.add(k)
                if p.pos1 <= end1 and p.end1 >= pos1:
                    cands.append(p)
        if len(cands) > 1:
            cands.sort(key=lambda p: (p.pos1, -p._accept_seq))
        return cands

    def above_below(self, anchor1: int):
        """(above_list, below_list) for get_above_below: first obi node
        with pos1 > anchor1, first oed-traversal node with
        end1 < anchor1."""
        i = self._br(self._pos1_keys, anchor1)
        above = self._obi_nodes[i] if i < len(self._obi_nodes) else None
        j = self._bl(self._end1_keys, anchor1)
        below = self._oed_nodes[j - 1] if j > 0 else None
        return above, below

    def in_bbox(self, p1: int, p2: int) -> bool:
        for (b1lo, b1hi, b2lo, b2hi) in \
                self._bbox_bins.get(p1 >> self.BIN_SHIFT, ()):
            if b1lo <= p1 <= b1hi and b2lo <= p2 <= b2hi:
                return True
        return False

    def any_bbox_overlap(self, r1lo, r1hi, r2lo, r2hi) -> bool:
        """Does any accepted bounding box intersect the rectangle?"""
        sh = self.BIN_SHIFT
        lo = max(0, r1lo) >> sh
        hi = max(0, r1hi) >> sh
        seen = set()
        for b in range(lo, hi + 1):
            for box in self._bbox_bins.get(b, ()):
                if box in seen:
                    continue
                seen.add(box)
                (b1lo, b1hi, b2lo, b2hi) = box
                if not (b1hi < r1lo or b1lo > r1hi
                        or b2hi < r2lo or b2lo > r2hi):
                    return True
        return False


def format_alignment(v1, v2, start1, start2, stop1, stop2, s, script,
                     m: GAlign) -> Alignment:
    """reference format_alignment: record diagonal segments on m and
    produce the external Alignment."""
    beg1, end1 = start1 + 1, stop1 + 1
    beg2, end2 = start2 + 1, stop2 + 1
    height = end1 - beg1 + 1
    width = end2 - beg2 + 1
    i = j = 0
    op_ix = 0
    ops = script.ops
    while i < height or j < width:
        start_i, start_j = i, j
        run = 0
        while op_ix < len(ops) and ops[op_ix][0] == "S":
            run += ops[op_ix][1]
            op_ix += 1
        i += run
        j += run
        m.save_seg(beg1 + start_i - 1, beg2 + start_j - 1,
                   beg1 + i - 2, beg2 + j - 2)
        if i < height or j < width:
            if op_ix < len(ops):
                op, r = ops[op_ix]
                op_ix += 1
                if op == "I":
                    j += r
                else:
                    i += r
            else:
                break
    return Alignment(
        beg1=beg1, beg2=beg2, end1=end1, end2=end2,
        script=script, score=s, hsp_id=m.hsp_id)


# -- top-level driver ---------------------------------------------------------


def identical_sequences(seq1, seq2, scoring) -> tuple[bool, int]:
    if seq1.is_partitioned or seq2.is_partitioned:
        return False, 0
    if len(seq1.v) != len(seq2.v):
        return False, 0
    if seq1.rev_comp_flags != seq2.rev_comp_flags:
        return False, 0
    a = _upper(seq1.v)
    b = _upper(seq2.v)
    if not np.array_equal(a, b):
        return False, 0
    s = int(scoring.sub[a, b].astype(np.int64).sum())
    s = min(s, BEST_POSSIBLE)
    return True, s


def identical_partitioned_sequences(seq1, seq2) -> bool:
    """reference identical_partitioned_sequences (gapped_extend.c):
    same partition structure, same (case-folded) content."""
    if not (seq1.is_partitioned and seq2.is_partitioned):
        return False
    if seq1.rev_comp_flags != seq2.rev_comp_flags:
        return False
    if len(seq1.partitions) != len(seq2.partitions):
        return False
    for p1, p2 in zip(seq1.partitions, seq2.partitions):
        a = seq1.v[p1.sep_before + 1: p1.sep_after]
        b = seq2.v[p2.sep_before + 1: p2.sep_after]
        if len(a) != len(b):
            return False
        if not np.array_equal(_upper(a), _upper(b)):
            return False
    return True


def identical_partition_of_sequence(seq1, seq2) -> int:
    """reference identical_partition_of_sequence: index of the seq1
    partition whose (case-folded) content equals non-partitioned
    seq2, or -1."""
    if not seq1.is_partitioned or seq2.is_partitioned:
        return -1
    if seq1.rev_comp_flags != seq2.rev_comp_flags:
        return -1
    b = _upper(seq2.v)
    for ix, p1 in enumerate(seq1.partitions):
        a = seq1.v[p1.sep_before + 1: p1.sep_after]
        if len(a) == len(b) and np.array_equal(_upper(a), b):
            return ix
    return -1


def _identity_score(scoring, a, b) -> int:
    s = int(scoring.sub[_upper(a), _upper(b)].astype(np.int64).sum())
    return min(s, BEST_POSSIBLE)


def _upper(seg):
    out = seg.copy()
    lower = (out >= ord("a")) & (out <= ord("z"))
    out[lower] -= 32
    return out


def count_paired_bases(mp) -> int:
    """reference count_paired_bases (gapped_extend.c:5693-5705): total
    bases in the alignment's diagonal segments."""
    n = 0
    bp = mp.first_seg
    while bp is not None:
        if bp.type == DIAG_SEG:
            n += bp.e1 + 1 - bp.b1
        bp = bp.next_seg
    return n


def gapped_extend(target, query, scoring, anchors: SegmentTable,
                  inhibit_trivial=False, y_drop=9400, trim_to_peak=True,
                  score_thresh=None, traceback_mem=80 * 1024 * 1024,
                  all_bounds=False, max_paired_bases=0,
                  overly_paired_warn=False, overly_paired_keep=False,
                  on_overly_paired=None, use_device=True,
                  truncation_report=True, device=None, target_state=None):
    """reference gapped_extend (gapped_extend.c:1012), unpartitioned path.

    Returns list of Alignment in increasing-start order.  When
    use_device is on, extensions run batched through the exact y-drop
    kernel on `device` (the pipeline's; device.get_device() when None),
    and only anchors whose DP could interact with previously accepted
    alignments run on the host engine (see align/ydrop_device.py); a
    device failure is an error.  `target_state`, the run's
    device.TargetState, hands the device stage the target's codes.
    """
    thresh = score_thresh.s if score_thresh is not None else 0

    aligner = YDropAligner(target.v, query.v, scoring, y_drop, trim_to_peak,
                           traceback_mem,
                           truncation_report=truncation_report)

    # sort anchors by decreasing score (reference batched_segments ->
    # qSegmentsByDecreasingScore; ties prefer shorter, then pos2, pos1, id)
    segs = sorted(
        anchors.segments,
        key=lambda g: (-g.score, g.length, g.pos2, g.pos1, g.seg_id))

    msps = []
    for k, seg in enumerate(segs):
        g = GAlign(pos1=seg.pos1, pos2=seg.pos2,
                   end1=seg.pos1 + seg.length - 1,
                   end2=seg.pos2 + seg.length - 1,
                   hsp_id=seg.hsp_id if seg.hsp_id else k + 1)
        msps.append(g)

    device = None
    if use_device and segs:
        seg_infos = []
        for seg in segs:
            low1, high1 = 0, len(target.v)
            low2, high2 = 0, len(query.v)
            if target.is_partitioned:
                p1 = target.lookup_partition(seg.pos1)
                low1, high1 = p1.sep_before + 1, p1.sep_after
            if query.is_partitioned:
                p2 = query.lookup_partition(seg.pos2)
                low2, high2 = p2.sep_before + 1, p2.sep_after
            seg_infos.append((seg.pos1, seg.pos2, low1, high1,
                              low2, high2))
        from ..device import get_device
        from .ydrop_device import DeviceYDrop
        device = DeviceYDrop(target.v, query.v, scoring, y_drop,
                             trim_to_peak, traceback_mem, seg_infos,
                             get_device() if device is None else device,
                             target=target_state)
        if not device.ok:
            device = None
    # incremental index over accepted alignments: obi/oed linked lists,
    # stab/overlap bins, and the device-safety bounding boxes
    aidx = AcceptIndex()
    n_bbox = 0

    if device is not None:
        # lazy-batch heuristic: don't speculatively extend anchors
        # whose point already lies inside an accepted alignment's box
        # (their device result would be rejected by the overlap test
        # below anyway, and most are killed by msp_left_right)
        device.precheck = (
            lambda j: not aidx.in_bbox(device.seg_infos[j][0],
                                       device.seg_infos[j][1]))

    obi = oed = None
    paired_bases = 0

    # trivial self-alignment
    trivial_mp = None
    is_ident, ident_score = identical_sequences(target, query, scoring)
    if is_ident:
        mp = GAlign(pos1=0, pos2=0,
                    end1=len(target.v) - 1, end2=len(target.v) - 1)
        mp.save_seg(mp.pos1, mp.pos2, mp.end1, mp.end2)
        aidx.insert(mp)
        obi, oed = aidx.obi, aidx.oed
        mp.last_seg = mp.first_seg
        mp.first_seg.prev_seg = None
        mp.last_seg.next_seg = None
        script = EditScript()
        script.add("S", len(target.v))
        a = Alignment(beg1=1, beg2=1, end1=len(target.v), end2=len(target.v),
                      script=script,
                      score=max(ident_score, thresh), is_trivial=True)
        mp.align = a
        trivial_mp = mp
        aidx.add_bbox(0, len(target.v) - 1, 0, len(target.v) - 1)
        n_bbox += 1
    else:
        # partitioned triviality (gapped_extend.c:1123-1280): insert a
        # trivial alignment per identical partition pair so that
        # off-diagonal anchors cannot merge onto the main diagonal;
        # --nomirror discards them at output like the plain case
        triv_pairs = []
        if target.is_partitioned and not query.is_partitioned:
            ix = identical_partition_of_sequence(target, query)
            if ix >= 0:
                p1 = target.partitions[ix]
                triv_pairs = [(p1.sep_before + 1, p1.sep_after - 1,
                               0, len(query.v) - 1)]
        elif target.is_partitioned and query.is_partitioned \
                and identical_partitioned_sequences(target, query):
            triv_pairs = [
                (p1.sep_before + 1, p1.sep_after - 1,
                 p2.sep_before + 1, p2.sep_after - 1)
                for p1, p2 in zip(target.partitions, query.partitions)]
        for (b1, e1, b2, e2) in triv_pairs:
            mp = GAlign(pos1=b1, pos2=b2, end1=e1, end2=e2)
            mp.save_seg(b1, b2, e1, e2)
            aidx.insert(mp)
            obi, oed = aidx.obi, aidx.oed
            mp.last_seg = mp.first_seg
            mp.first_seg.prev_seg = None
            mp.last_seg.next_seg = None
            s = _identity_score(scoring, target.v[b1:e1 + 1],
                                query.v[b2:e2 + 1])
            script = EditScript()
            script.add("S", e1 - b1 + 1)
            a = Alignment(beg1=b1 + 1, beg2=b2 + 1,
                          end1=e1 + 1, end2=e2 + 1, script=script,
                          score=max(s, thresh), is_trivial=True)
            mp.align = a
            aidx.add_bbox(b1, e1, b2, e2)
            n_bbox += 1

    for k, mp in enumerate(msps):
        if not msp_left_right(obi, mp, cands=aidx.stab(mp.pos1)):
            if device is not None:
                device.release(k)
            continue
        aligner.left_align = mp.left_align1
        aligner.right_align = mp.right_align1
        aligner.left_seg = mp.left_seg1
        aligner.right_seg = mp.right_seg1
        aligner.above_list, aligner.below_list = \
            aidx.above_below(mp.pos1)

        # partitioned sequences: clamp the DP to the anchor's partition
        # (gapped_extend.c:1355-1375)
        if target.is_partitioned:
            p1 = target.lookup_partition(mp.pos1)
            aligner.low1, aligner.high1 = p1.sep_before + 1, p1.sep_after
        if query.is_partitioned:
            p2 = query.lookup_partition(mp.pos2)
            aligner.low2, aligner.high2 = p2.sep_before + 1, p2.sep_after

        from .. import stats as _stats
        _x = _stats.current.extra
        use_dev = device is not None
        if use_dev and not (mp.left_seg1 is None
                            and mp.right_seg1 is None):
            use_dev = False
            _x["dev-skip bounded"] = _x.get("dev-skip bounded", 0) + 1
        if use_dev and aidx.in_bbox(mp.pos1, mp.pos2):
            use_dev = False
            _x["dev-skip in-bbox"] = _x.get("dev-skip in-bbox", 0) + 1
        if use_dev:
            device.result_for(k)
            use_dev = device.statuses_ok(k)
            if not use_dev:
                _x["dev-skip status"] = _x.get("dev-skip status", 0) + 1
        if use_dev and n_bbox:
            r1lo, r1hi, r2lo, r2hi = device.explored_rect(k)
            if aidx.any_bbox_overlap(r1lo, r1hi, r2lo, r2hi):
                use_dev = False
                _x["dev-skip overlap"] = \
                    _x.get("dev-skip overlap", 0) + 1
        if use_dev:
            device.stats_device += 1
            s, start1, start2, stop1, stop2, script = device.compose(
                aligner, k, mp.pos1, mp.pos2)
        else:
            if device is not None:
                device.stats_host += 1
            from .. import stats as _stats
            with _stats.current.time("ydrop host", span=False):
                s, start1, start2, stop1, stop2, script = \
                    aligner.ydrop_align(mp.pos1, mp.pos2)
        if device is not None:
            device.release(k)
        anchor_pos1 = mp.pos1
        mp.align = None
        a = format_alignment(target.v, query.v, start1, start2, stop1, stop2,
                             s, script, mp)
        mp.align = a
        mp.pos1, mp.pos2 = start1, start2
        mp.end1, mp.end2 = stop1, stop2

        if mp.first_seg is None:
            continue
        mp.last_seg = mp.first_seg.prev_seg
        mp.first_seg.prev_seg = None
        mp.last_seg.next_seg = None

        if (not all_bounds) and a.score < thresh:
            mp.first_seg = mp.last_seg = None
            continue

        align_left_right(obi, mp,
                         cands=aidx.overlapping(mp.pos1, mp.end1))
        aidx.insert(mp)
        obi, oed = aidx.obi, aidx.oed
        aidx.add_bbox(mp.pos1, mp.end1, mp.pos2, mp.end2)
        n_bbox += 1

        # paired-bases limit (gapped_extend.c:1444-1459): stop processing
        # HSPs; without 'keep', discard everything for this query/strand
        if max_paired_bases > 0:
            paired_bases += count_paired_bases(mp)
            if paired_bases > max_paired_bases:
                if overly_paired_warn and on_overly_paired is not None:
                    on_overly_paired()
                if not overly_paired_keep:
                    return []
                break

    from .. import stats as _stats
    _stats.current.gapped_anchors += len(msps)
    if device is not None:
        _stats.current.gapped_device += device.stats_device
        _stats.current.gapped_host += device.stats_host
    else:
        _stats.current.gapped_host += len(msps)

    # collect qualifying alignments in obi order
    out = []
    mp = obi
    while mp is not None:
        a = mp.align
        keep = a is not None and a.score >= thresh
        if keep and inhibit_trivial and a.is_trivial:
            keep = False
        if keep:
            out.append(a)
        mp = mp.next
    _stats.current.alignments += len(out)
    return out
