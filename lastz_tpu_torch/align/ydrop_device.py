"""Device-batched gapped extension: the glue between K1 (through
its mega launch, ops/ydrop_cuda.ydrop_mega) and the sequential accept
loop of
gapped_extend (align/ydrop.py; reference gapped_extend.c:1012).

Port of lastz_tpu/align/ydrop_device.py::DeviceYDrop.  Anchors are
extended speculatively on the device, both directions of a batch in
one mega launch, unconstrained by earlier alignments.  The accept loop
takes a device result only where it is provably what the constrained
host DP would give: the anchor has no bounding segments and no
accepted alignment's box meets the rectangle the device DP explored.
Everything else (bounded anchors, window overflow, traceback redo)
goes to the host engine for that anchor, and --stats counts it.

  * lane layout: B anchors are 2B lanes, forward then reverse;
  * one packed fetch of the per-lane scalars per launch;
  * lanes still running after `max_blocks` chunks continue, score
    only, compacted into a batch of just those lanes;
  * the traceback of every finished lane runs on the device in one
    call (csrc/ydrop_traceback.cu) and is decoded on the host.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import stats as _stats
from ..device import upload_codes
from ..ops.ydrop_cuda import traceback_mega, ydrop_mega
from .edit_script import EditScript
from ..ops.ydrop_exact import (MAX_COMP_GAP_E, ST_TRUNCATED,
                               fresh_state_np, make_compact_alphabet)

DEFAULT_WIDTH = 768
DEFAULT_ROWS = 1024
DEFAULT_BATCH = 64
DEFAULT_BLOCKS = 8

_OP_CHR = {1: "S", 2: "I", 3: "D"}


class DeviceYDrop:
    """Per-strand batched extension cache over a sorted anchor list."""

    _MAX_CHUNKS = 4096

    def __init__(self, v1, v2, scoring, y_drop, trim_to_peak,
                 traceback_mem, seg_infos, device):
        """seg_infos: list of (anchor1, anchor2, low1, high1, low2,
        high2) in accept order (decreasing score)."""
        self.ok = False
        self.v1 = v1
        self.v2 = v2
        self.device = device
        self.trim_to_peak = trim_to_peak
        self.width = DEFAULT_WIDTH
        self.rows = DEFAULT_ROWS
        self.batch = DEFAULT_BATCH
        self.max_blocks = DEFAULT_BLOCKS
        self.tb_cap = int(traceback_mem)
        self.seg_infos = seg_infos
        self.y_drop = y_drop
        # callback: may anchor index j still produce an alignment?
        # (set by gapped_extend to an msp_left_right precheck)
        self.precheck = None
        self.stats_device = 0
        self.stats_host = 0

        # exactness gates (ydrop_device.py:85-102): the kernel's int32
        # sentinels are safe only inside them; anything else runs on
        # the host
        sub = scoring.sub
        if sub.dtype != np.int64 or sub.shape != (256, 256):
            return
        if not (0 <= scoring.gap_extend <= MAX_COMP_GAP_E):
            return
        if np.abs(sub).max() >= (1 << 31):
            return
        self.gap_e = int(scoring.gap_extend)
        self.gap_oe = int(scoring.gap_open + scoring.gap_extend)
        if abs(self.gap_oe) >= (1 << 30) or int(y_drop) >= (1 << 30):
            return
        if self.tb_cap >= (1 << 31):
            return
        cmap_sub = make_compact_alphabet([v1, v2], sub, max_k=16)
        if cmap_sub is None:
            return
        self.code_map, self.subsmall = cmap_sub
        # window capacity: must exceed the widest possible band (about
        # 2*yDrop/gapE + drift margin)
        self.lanes = self.width * 2
        self._results: dict[int, dict] = {}
        self._ops: dict[int, tuple] = {}
        self._computed: set[int] = set()
        self._v1c = self._v2c = None
        self.ok = True

    def _collect_batch(self, ix):
        """Next up-to-batch anchor indices in accept order, starting
        at ix, skipping anchors already computed or provably dead."""
        idxs = [ix]
        j = ix + 1
        n = len(self.seg_infos)
        while len(idxs) < self.batch and j < n:
            if j not in self._computed and (
                    self.precheck is None or self.precheck(j)):
                idxs.append(j)
            j += 1
        self._computed.update(idxs)
        return idxs

    def _ensure_seqs(self):
        if self._v1c is None:
            self._v1c = upload_codes(self.v1, self.code_map, self.device)
            self._v2c = upload_codes(self.v2, self.code_map, self.device)

    def _target_args(self, A1, LO1, HI1, REV, row0, rows, max_blocks):
        """Target codes and per-lane seq1 coordinates (A1, LO1, HI1) of
        one mega launch whose lanes sit at DP row `row0` (the kernel
        reads seq1 only inside rows [row0, row0 + max_blocks*rows) of
        each lane's anchor).  Base class: the whole-target upload and
        the coordinates as they are (align/ydrop_sharded.py remaps them
        onto windows gathered from the shards)."""
        del REV, row0, rows, max_blocks

        def T(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return self._v1c, T(A1), T(LO1), T(HI1)

    def _compute_for(self, ix):
        dev = self.device
        self._ensure_seqs()
        idxs = self._collect_batch(ix)
        B = self.batch
        lanes = self.lanes
        # lane layout: [fwd x B (padded), rev x B (padded)]
        info = np.zeros((2 * B, 6), np.int64)
        info[: len(idxs)] = [self.seg_infos[k] for k in idxs]
        info[B: B + len(idxs)] = info[: len(idxs)]
        A1, A2, LO1, HI1, LO2, HI2 = info.T.astype(np.int32)
        REV = np.arange(2 * B) >= B
        M = np.zeros(2 * B, np.int32)
        N = np.zeros(2 * B, np.int32)
        n = len(idxs)
        M[:n] = HI1[:n] - (A1[:n] + 1)
        N[:n] = HI2[:n] - (A2[:n] + 1)
        M[B: B + n] = (A1[B: B + n] + 1) - LO1[B: B + n]
        N[B: B + n] = (A2[B: B + n] + 1) - LO2[B: B + n]

        st_np, _ = fresh_state_np(
            N.astype(np.int64), self.gap_e, self.gap_oe,
            int(self.y_drop), lanes, 2 * B)

        def T(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        state = {k: T(v) for k, v in st_np.items()}
        kw = dict(gap_e=self.gap_e, gap_oe=self.gap_oe,
                  y_drop=int(self.y_drop), lanes=lanes, rows=self.rows,
                  max_blocks=self.max_blocks,
                  alpha=self.subsmall.shape[0],
                  trim_to_peak=self.trim_to_peak, tb_cap=self.tb_cap)
        subsmall = T(self.subsmall)
        # the target and its lanes' coordinates come from the hook, the
        # first launch's and every continuation's
        v1c, A1t, LO1t, HI1t = self._target_args(
            A1, LO1, HI1, REV, np.zeros(2 * B, np.int64), self.rows,
            self.max_blocks)
        lane_args = [A1t, T(A2), LO1t, HI1t, T(LO2), T(HI2), T(REV), T(M),
                     T(N)]

        _x = _stats.current.extra
        t_launch = _stats.current.time("ydrop device")
        t_launch.__enter__()
        state, prev_off, packed, tb_all, row_lo, row_hi, col0 = ydrop_mega(
            v1c, self._v2c, *lane_args, state,
            T(np.zeros(2 * B, np.int32)), subsmall, with_tb=True, **kw)
        pk = packed.cpu().numpy()
        done1 = pk[3].astype(bool)
        blocks = self.max_blocks
        launches = 1
        cont_lanes = 0
        # score-only continuation for extensions beyond the retained
        # blocks (their traceback is redone on the host); only the
        # live lanes go on
        undone = np.nonzero(~done1)[0]
        if len(undone):
            sel = T(undone)
            c_args = [a[sel] for a in lane_args]
            c_state = {k: v[sel] for k, v in state.items()}
            c_prev = prev_off[sel]
            row_c = pk[0][undone].astype(np.int64)
            while blocks < self._MAX_CHUNKS:
                # the target's coordinates again at the lanes' rows (the
                # sharded subclass re-extracts its windows as they go)
                v1c, c_args[0], c_args[2], c_args[3] = self._target_args(
                    A1[undone], LO1[undone], HI1[undone], REV[undone],
                    np.maximum(row_c - 1, 0), self.rows, self.max_blocks)
                c_state, c_prev, c_packed, _, _, _, _ = ydrop_mega(
                    v1c, self._v2c, *c_args, c_state, c_prev,
                    subsmall, with_tb=False, **kw)
                cpk = c_packed.cpu().numpy()
                row_c = cpk[0].astype(np.int64)
                blocks += self.max_blocks
                launches += 1
                cont_lanes += len(undone)
                if cpk[3].astype(bool).all():
                    break
            pk[:, undone] = cpk
        # utilization / fallback visibility (--stats)
        real = np.zeros(2 * B, bool)
        real[: len(idxs)] = True
        real[B: B + len(idxs)] = True
        _x["ydrop launches"] = _x.get("ydrop launches", 0) + launches
        _x["ydrop rows used"] = (_x.get("ydrop rows used", 0)
                                 + int(pk[2][real].sum()))
        _x["ydrop rows launched"] = (
            _x.get("ydrop rows launched", 0)
            + (2 * B + cont_lanes) * self.max_blocks * self.rows)
        tb_redo = int((real & ~done1).sum())
        if tb_redo:
            # extensions longer than the retained traceback blocks:
            # device score kept, extension redone on the host
            _x["ydrop tb host-redo"] = (
                _x.get("ydrop tb host-redo", 0) + tb_redo)

        small = dict(
            row=pk[0], LY=pk[1], rows_used=pk[2], done=pk[3],
            status=pk[4], best=pk[5], end1=pk[6], end2=pk[7],
            bscore=pk[8], bflag=pk[9].astype(bool), tbp=pk[10],
            maxRY=pk[11])
        small["score"] = np.where(small["bflag"], small["bscore"],
                                  small["best"])

        # device traceback over the retained blocks, one call
        cap = self.max_blocks * self.rows + lanes + 512
        ops_d, n_d, row_d, col_d = traceback_mega(
            tb_all, row_lo, row_hi, col0, packed[12], T(small["end1"]),
            T(small["end2"]), T(done1), cap)
        del tb_all
        meta = torch.stack([n_d, row_d, col_d]).cpu().numpy()
        n_np, row_np, col_np = meta
        t_launch.__exit__()
        ops_ok = done1 & (n_np < cap) & (row_np <= 0) & (col_np <= 0)
        ok_lanes = np.nonzero(ops_ok)[0]
        ops_np = np.zeros((2 * B, cap), np.uint8)
        if len(ok_lanes):
            ops_np[ok_lanes] = ops_d[T(ok_lanes)].cpu().numpy()

        for j, k in enumerate(idxs):
            fwd = {key: small[key][j] for key in small}
            rev = {key: small[key][B + j] for key in small}
            fwd["ops_ok"] = bool(ops_ok[j])
            rev["ops_ok"] = bool(ops_ok[B + j])
            self._results[k] = {"fwd": fwd, "rev": rev}
            of = [_OP_CHR[int(c)] for c in ops_np[j, : n_np[j]]] \
                if ops_ok[j] else []
            orv = [_OP_CHR[int(c)] for c in ops_np[B + j, : n_np[B + j]]] \
                if ops_ok[B + j] else []
            self._ops[k] = (of, orv)

    def result_for(self, ix):
        if ix not in self._results:
            self._compute_for(ix)
        return self._results[ix]

    def release(self, ix):
        """Drop an anchor's cached result/ops (host side; the device
        traceback buffers are freed at the end of each batch)."""
        self._results.pop(ix, None)
        self._ops.pop(ix, None)

    # -- safety ----------------------------------------------------------

    def explored_rect(self, ix):
        """Sequence-coordinate rectangle the device DP touched, both
        directions, expanded by 1 (for the L/R bound column offsets)."""
        res = self._results[ix]
        a1, a2 = self.seg_infos[ix][0], self.seg_infos[ix][1]
        rf = int(res["fwd"]["rows_used"])
        cf = int(res["fwd"]["maxRY"])
        rr = int(res["rev"]["rows_used"])
        cr = int(res["rev"]["maxRY"])
        return (a1 - rr - 1, a1 + rf + 1, a2 - cr - 1, a2 + cf + 1)

    def statuses_ok(self, ix):
        res = self._results[ix]
        for w in ("fwd", "rev"):
            if int(res[w]["status"]) & ~ST_TRUNCATED:
                return False
            if not res[w]["ops_ok"]:
                return False
        return True

    # -- composing a device alignment ------------------------------------

    def compose(self, aligner, ix, anchor1, anchor2):
        """Replicates YDropAligner.ydrop_align from device results
        (align/ydrop.py YDropAligner.ydrop_align; gapped_extend.c:2459)."""
        res = self.result_for(ix)
        rev, fwd = res["rev"], res["fwd"]

        self._maybe_report_truncation(aligner, rev, True,
                                      anchor1, anchor2)
        self._maybe_report_truncation(aligner, fwd, False,
                                      anchor1, anchor2)

        ops_fwd, ops_rev = self._ops[ix]
        start1 = anchor1 + 1 - int(rev["end1"])
        start2 = anchor2 + 1 - int(rev["end2"])
        stop1 = anchor1 + int(fwd["end1"])
        stop2 = anchor2 + int(fwd["end2"])

        script = EditScript()
        for op in ops_rev:
            script.add(op, 1)
        for op in reversed(ops_fwd):
            script.add(op, 1)

        s = int(rev["score"]) + int(fwd["score"])
        if script.ops:
            if script.ops[0][0] != "S":
                start1, start2, s = aligner._lop_initial(
                    script, start1, start2)
            if script.ops and script.ops[-1][0] != "S":
                stop1, stop2, s = aligner._lop_final(
                    script, start1, start2, stop1, stop2)
        return s, start1, start2, stop1, stop2, script

    def _maybe_report_truncation(self, aligner, res, reversed_,
                                 anchor1, anchor2):
        if not (int(res["status"]) & ST_TRUNCATED):
            return
        if not aligner.report_truncations:
            return  # --notruncationreport
        end1, end2 = int(res["end1"]), int(res["end2"])
        if not reversed_:
            sys.stderr.write(
                f"truncating alignment ending at ({end1 + anchor1 + 1}"
                f",{end2 + anchor2 + 1});")
        else:
            sys.stderr.write(
                f"truncating alignment starting at ({anchor1 + 2 - end1}"
                f",{anchor2 + 2 - end2});")
        sys.stderr.write(f"  anchor at ({anchor1},{anchor2})\n")
        if not aligner.truncation_reported:
            aligner.truncation_reported = True
            sys.stderr.write(
                "truncation can be reduced by increasing traceback"
                " memory\n")
