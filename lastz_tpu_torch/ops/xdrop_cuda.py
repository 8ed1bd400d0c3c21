"""Wrapper of the seed stage's CUDA kernel.

  xdrop_scan   K2, csrc/xdrop_scan.cu; replaces the kernel of
               lastz_tpu/ops/xdrop_pallas.py::_make_kernel (:91),
               launched by xdrop_scan_pallas (:238), and, for
               alphabets of 17 to 256 codes, the x-drop of
               lastz_tpu/ops/xdrop_batch.py::batch_xdrop_jax (:309)

For CUDA tensors it launches the kernel's two stages on
torch.cuda.current_stream() (both directions of every hit, through one
C entry point: K <= 16 takes int8 codes, 16 < K <= 256 the wide
instantiation on uint8 codes) and raises when the launch fails; it
takes the plain version (ops/hitgen.xdrop_scan_plain, for every K) only
for tensors on the CPU.  `xdrop_scan.launches` counts calls of either
entry point and nothing else, `xdrop_scan.wide_launches` those of the
wide one.  What bounds the kernel on the card is noted at the top of
its source.
"""

from __future__ import annotations

import torch

from ..device import SEQ_PAD
from ..kernels import build
from .hitgen import xdrop_scan_plain

_I32 = torch.int32


def xdrop_scan(seq1p, seq2p, subflat, K: int, pos1, pos2, n_l, n_r,
               x_drop: int):
    """Both-direction x-drop scans of H hits over the SEQ_PAD-padded
    codes (int8 for K <= 16, uint8 for 16 < K <= 256) with the K x K
    table subflat: left from (pos1-1, pos2-1) over n_l cells, right from
    (pos1, pos2) over n_r cells.  Returns ((lc, lb, lk), (rc, rb, rk))
    of (consumed, best, kbest) per side."""
    if pos1.device.type == "cpu":
        left = xdrop_scan_plain(seq1p, seq2p, subflat, K, pos1 - 1,
                                pos2 - 1, n_l, x_drop, -1)
        right = xdrop_scan_plain(seq1p, seq2p, subflat, K, pos1, pos2,
                                 n_r, x_drop, +1)
        return left, right
    if pos1.device.type != "cuda":
        raise ValueError(f"xdrop_scan: unsupported device {pos1.device}")
    wide = K > 16
    code = torch.uint8 if wide else torch.int8
    if seq1p.dtype != code or seq2p.dtype != code:
        raise ValueError(f"xdrop_scan: K = {K} takes {code} codes")
    if not 0 < K <= 256 or subflat.numel() < K * K:
        raise ValueError("xdrop_scan: score table must be K x K, K <= 256")
    H = pos1.shape[0]
    out = torch.empty((6, H), dtype=_I32, device=pos1.device)
    if H == 0:
        return tuple(out[:3]), tuple(out[3:])
    s1 = seq1p.contiguous()
    s2 = seq2p.contiguous()
    sub = subflat.to(_I32).contiguous()
    p1, p2, nl, nr = (a.to(_I32).contiguous()
                      for a in (pos1, pos2, n_l, n_r))
    # stage 1's queue of the walks it hands to stage 2, and the counts
    # of queued and taken walks
    queue = torch.empty(2 * H, dtype=_I32, device=pos1.device)
    counters = torch.zeros(2, dtype=_I32, device=pos1.device)
    lib = build.load()
    entry = lib.xdrop_scan_wide_launch if wide else lib.xdrop_scan_launch
    rc = entry(
        s1.data_ptr(), s2.data_ptr(), sub.data_ptr(), K, p1.data_ptr(),
        p2.data_ptr(), nl.data_ptr(), nr.data_ptr(), H, x_drop, SEQ_PAD,
        out.data_ptr(), queue.data_ptr(), counters.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "xdrop_scan")
    build.count(xdrop_scan, wide_launches=int(wide))
    return tuple(out[:3]), tuple(out[3:])


xdrop_scan.launches = 0
xdrop_scan.wide_launches = 0
