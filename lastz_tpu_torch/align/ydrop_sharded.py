"""Gapped (y-drop) extension over a SHARDED target: no device ever holds
the whole target's codes, only its shard plus halo
(search/sharded_mesh.MeshShardedIndex residency).  Port of
lastz_tpu/align/ydrop_sharded.py.

This is the gapped-stage half of the beyond-memory tier (the reference
handles over-sized targets with wider-address builds, lastz_32/40,
src/Makefile tiers).  The seed/HSP half runs shard-locally
(search/sharded_mesh.py); here K1's mega launch does too, exactly:

  * K1 (ops/ydrop_cuda.ydrop_mega) reads seq1 only inside each lane's
    per-launch READ BAND: rows [row0, row0 + max_blocks*rows) relative
    to the anchor, masked by [low1, high1).  So one launch needs one
    bounded window per lane, never the whole target.
  * extract_target_windows is an owner-gather: each slot slices, from
    its resident codes, the windows whose key its cover range owns and
    zeros the rest, and the parts are summed on the kernel's device
    (lastz_tpu's psum over the mesh).  Only windows cross devices.
  * ShardedTargetYDrop remaps each lane's (anchor1, low1, high1) onto
    the CONCATENATED windows, a "virtual target" of length B*Wt, and
    runs the unchanged mega launch and the walk on it.  The kernel
    reads the same codes at the same (remapped) indices, so scores,
    traceback and termination are bit-identical to the whole-target
    path (held lane for lane in tests/test_torch_sharded.py).  The
    kernel's rows report end1/end2 relative to the anchor, so nothing
    is mapped back.

Residency sizing rule: index.halo + 1 >= max_blocks*rows + 8 (one
launch's reach), else ok = False.  The defaults satisfy it:
LASTZ_TORCH_SHARD_HALO=32768 against 8*1024+8.  Continuation launches
re-extract windows at the lanes' advanced rows, so the total extension
length is unbounded as before.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import SEQ_PAD, upload_codes
from ..search.sharded_mesh import slot_context
from .ydrop_device import DeviceYDrop


def extract_target_windows(index, win_lo: np.ndarray, keys: np.ndarray,
                           Wt: int, device=None) -> torch.Tensor:
    """(B, Wt) int8 compact codes of the absolute windows [win_lo,
    win_lo + Wt), gathered from the shard-resident slices and summed on
    `device` (slot 0's by default).  `keys` picks each window's owning
    shard (a point inside the owned cover that the window provably
    stays within halo distance of)."""
    cmax = index.cmax
    if cmax < Wt:
        raise ValueError("shard residency narrower than the window")
    device = index.slots[0] if device is None else torch.device(device)
    keys = np.ascontiguousarray(keys, np.int64)
    win_lo = np.ascontiguousarray(win_lo, np.int64)
    parts = []
    for d in range(index.n_shards):
        dev = index.slots[d]
        with slot_context(dev):
            k = torch.from_numpy(keys).to(dev)
            lo = torch.from_numpy(win_lo).to(dev)
            own = (k >= int(index.cov[d])) & (k < int(index.cov[d + 1]))
            rel = torch.clamp(lo - (int(index.res_lo[d]) - SEQ_PAD), 0,
                              cmax - Wt)
            at = rel[:, None] + torch.arange(Wt, device=dev)[None, :]
            wins = index.codes_d[d][at]
            parts.append(torch.where(own[:, None], wins, 0))
    # every window has exactly one owner: the sum is a gather
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


class ShardedTargetYDrop(DeviceYDrop):
    """DeviceYDrop whose kernel target comes from the shard residency.

    Construction mirrors DeviceYDrop but takes the MeshShardedIndex
    first; the host seq1 bytes are still needed for the base class's
    parameter checks (host memory; the device never sees them).  ok is
    False when the residency halo cannot cover one launch's read
    band."""

    def __init__(self, index, v1, v2, scoring, y_drop, trim_to_peak,
                 traceback_mem, seg_infos, device, target=None):
        self.index = index
        super().__init__(v1, v2, scoring, y_drop, trim_to_peak,
                         traceback_mem, seg_infos, device, target)
        if not self.ok:
            return
        # the kernel must read the same compact codes the shards hold
        self.code_map = index.code_map
        self.subsmall = index.subsmall
        wt = self.max_blocks * self.rows + 8
        if index.halo + 1 < wt or index.n < wt:
            self.ok = False

    def _ensure_seqs(self):
        if self._v2c is None:
            self._v2c = upload_codes(self.v2, self.code_map, self.device)

    def _target_args(self, A1, LO1, HI1, REV, row0, rows, max_blocks):
        n = self.index.n
        B = len(A1)
        Wt = max_blocks * rows + 8
        a1 = A1.astype(np.int64)
        row0 = row0.astype(np.int64)
        # per-lane read band start (forward reads go up from a1+1+row0,
        # reverse reads down from a1-row0); clamping only sheds
        # positions the kernel masks anyway (forward: < high1; reverse:
        # the band never exceeds a1 <= n-1)
        win = np.where(REV, a1 - row0 - (Wt - 1), a1 + 1 + row0)
        win = np.clip(win, 0, max(0, n - Wt))
        keys = np.clip(np.where(REV, win + Wt - 1, win), 0, n - 1)
        wins = extract_target_windows(self.index, win, keys, Wt,
                                      self.device)
        # virtual target: lane j's window occupies [j*Wt, (j+1)*Wt); the
        # remap is affine, so a1' +- (row_base + r) lands on the code the
        # absolute index would have read (K1 clips at B*Wt - 1, which
        # only masked reads reach)
        vbase = np.arange(B, dtype=np.int64) * Wt
        A1v = vbase + (a1 - win)
        LO1v = vbase + np.clip(LO1.astype(np.int64) - win, 0, Wt)
        HI1v = vbase + np.clip(HI1.astype(np.int64) - win, 0, Wt)

        def T(a):
            return torch.from_numpy(a.astype(np.int32)).to(self.device)
        return wins.reshape(B * Wt), T(A1v), T(LO1v), T(HI1v)
