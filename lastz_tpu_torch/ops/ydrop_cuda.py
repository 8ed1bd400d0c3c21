"""Wrappers of the gapped stage's CUDA kernels.

  ydrop_chunk     K1, csrc/ydrop_chunk.cu; replaces
                  lastz_tpu/ops/ydrop_pallas_exact.py::_kernel (:79)
  ydrop_mega      K1's mega launch, the same source; replaces the
                  device while_loop of ydrop_mega_pallas (:434)
  traceback_mega  csrc/ydrop_traceback.cu; replaces the device
                  while_loop lastz_tpu/ops/ydrop_exact.py::
                  traceback_mega_dev (:675)

Each wrapper launches its kernel on torch.cuda.current_stream() for
CUDA tensors and raises when the launch fails; it takes its plain
PyTorch version (ops/ydrop_exact.py) only for tensors on the CPU.
`<wrapper>.launches` counts kernel launches and nothing else.
What bounds each kernel on the card, and what its design does about
it, is noted at the top of its source.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .ydrop_exact import (SCALAR_KEYS, pack_scalars, traceback_mega_plain,
                          y_drop_tail, ydrop_chunk_plain, ydrop_mega_plain)

_I32 = torch.int32


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _i32(x) -> torch.Tensor:
    return x.to(_I32).contiguous()


def ydrop_chunk(a_small, b_small, b_off, shift, M, N, state, subsmall,
                *, gap_e: int, gap_oe: int, y_drop: int, lanes: int,
                rows: int, alpha: int, trim_to_peak: bool, tb_cap: int,
                tb_out=None, want_tb: bool = True):
    """One resumable chunk for B lanes (contract of
    ops/ydrop_exact.ydrop_chunk_plain).  With `tb_out`, a zeroed
    (B, rows+1, lanes) uint8 view whose rows are contiguous, the link
    bytes are written there and it is returned as tb; without
    `want_tb` the kernel writes no link bytes and tb is None."""
    kw = dict(gap_e=gap_e, gap_oe=gap_oe, y_drop=y_drop, lanes=lanes,
              rows=rows, alpha=alpha, trim_to_peak=trim_to_peak,
              tb_cap=tb_cap)
    if a_small.device.type == "cpu":
        st, tb = ydrop_chunk_plain(a_small, b_small, b_off, shift, M, N,
                                   state, subsmall, **kw)
        if tb_out is not None:
            tb_out.copy_(tb)
            tb = tb_out
        return st, (tb if want_tb else None)
    if a_small.device.type != "cuda":
        raise ValueError(f"ydrop_chunk: unsupported device {a_small.device}")
    B, W = b_small.shape
    if W != lanes or a_small.shape != (B, rows) or B == 0:
        raise ValueError("ydrop_chunk: shapes do not match lanes/rows")
    if tuple(subsmall.shape) != (16, 16):
        raise ValueError("ydrop_chunk: subsmall must be 16x16")
    if not 0 < W <= 2048 or not 0 <= tb_cap < (1 << 31):
        raise ValueError("ydrop_chunk: window or tb_cap out of range")
    if want_tb and tb_out is None:
        tb_out = torch.zeros((B, rows + 1, W), dtype=torch.uint8,
                             device=a_small.device)
    if want_tb and (tb_out.shape != (B, rows + 1, W)
                    or tb_out.stride()[1:] != (W, 1)):
        raise ValueError("ydrop_chunk: tb_out layout")
    CC = state["CC"].to(_I32).clone(memory_format=torch.contiguous_format)
    DD = state["DD"].to(_I32).clone(memory_format=torch.contiguous_format)
    sc = torch.stack([state[k].to(_I32) for k in SCALAR_KEYS],
                     dim=1).contiguous()
    args = [_i32(a_small), _i32(b_small), _i32(b_off), _i32(shift),
            _i32(M), _i32(N)]
    sub = _i32(subsmall)
    lib = build.load()
    rc = lib.ydrop_chunk_launch(
        *[t.data_ptr() for t in args], CC.data_ptr(), DD.data_ptr(),
        sc.data_ptr(), sub.data_ptr(),
        tb_out.data_ptr() if want_tb else None,
        tb_out.stride(0) if want_tb else 0, B, W, rows, gap_e, gap_oe,
        y_drop, int(trim_to_peak), tb_cap, y_drop_tail(y_drop, gap_e),
        _stream())
    build.check(rc, "ydrop_chunk")
    build.count(ydrop_chunk)
    out = {"CC": CC, "DD": DD}
    for i, k in enumerate(SCALAR_KEYS):
        out[k] = sc[:, i] != 0 if k in ("bflag", "done") else sc[:, i]
    return out, (tb_out if want_tb else None)


ydrop_chunk.launches = 0


def ydrop_mega(v1c, v2c, a1, a2, low1, high1, low2, high2, rev, M, N,
               state, prev_off0, subsmall, *, gap_e: int, gap_oe: int,
               y_drop: int, lanes: int, rows: int, max_blocks: int,
               alpha: int, trim_to_peak: bool, tb_cap: int,
               with_tb: bool = True):
    """Up to `max_blocks` chunks of every lane in one launch (contract
    of ops/ydrop_exact.ydrop_mega_plain): (state', prev_off', packed
    (13, B), tb_all, row_lo, row_hi, col0).  v1c/v2c are the int8
    compact codes of the two sequences, resident on the card; the
    state is copied once, and the kernel updates the copy in place."""
    kw = dict(gap_e=gap_e, gap_oe=gap_oe, y_drop=y_drop, lanes=lanes,
              rows=rows, max_blocks=max_blocks, alpha=alpha,
              trim_to_peak=trim_to_peak, tb_cap=tb_cap, with_tb=with_tb)
    if v1c.device.type == "cpu":
        return ydrop_mega_plain(v1c, v2c, a1, a2, low1, high1, low2, high2,
                                rev, M, N, state, prev_off0, subsmall, **kw)
    if v1c.device.type != "cuda":
        raise ValueError(f"ydrop_mega: unsupported device {v1c.device}")
    B = a1.shape[0]
    W = lanes
    dev = v1c.device
    if v1c.dtype != torch.int8 or v2c.dtype != torch.int8:
        raise ValueError("ydrop_mega: sequences must be int8 codes")
    if tuple(subsmall.shape) != (16, 16):
        raise ValueError("ydrop_mega: subsmall must be 16x16")
    if (B == 0 or not 0 < W <= 2048 or rows <= 0 or max_blocks <= 0
            or not 0 <= tb_cap < (1 << 31) or v1c.numel() == 0
            or v2c.numel() == 0 or tuple(state["CC"].shape) != (B, W)):
        raise ValueError("ydrop_mega: shapes or tb_cap out of range")
    CC = state["CC"].to(_I32).clone(memory_format=torch.contiguous_format)
    DD = state["DD"].to(_I32).clone(memory_format=torch.contiguous_format)
    sc = torch.stack([state[k].to(_I32) for k in SCALAR_KEYS],
                     dim=1).contiguous()
    prev = prev_off0.to(_I32).clone(memory_format=torch.contiguous_format)
    tb_all = torch.zeros((B, max_blocks, rows + 1, W) if with_tb
                         else (B, 1, 1, 1), dtype=torch.uint8, device=dev)
    row_lo, row_hi, col0 = (torch.zeros((B, max_blocks), dtype=_I32,
                                        device=dev) for _ in range(3))
    nblk = torch.empty(B, dtype=_I32, device=dev)
    lane = [_i32(x) for x in (a1, a2, low1, high1, low2, high2)]
    rv = rev.to(torch.uint8).contiguous()
    m, n = _i32(M), _i32(N)
    sub = _i32(subsmall)
    s1, s2 = v1c.contiguous(), v2c.contiguous()
    rc = build.load().ydrop_mega_launch(
        s1.data_ptr(), s1.numel(), s2.data_ptr(), s2.numel(),
        *[t.data_ptr() for t in lane], rv.data_ptr(), m.data_ptr(),
        n.data_ptr(), CC.data_ptr(), DD.data_ptr(), sc.data_ptr(),
        prev.data_ptr(), sub.data_ptr(),
        tb_all.data_ptr() if with_tb else None, max_blocks,
        row_lo.data_ptr(), row_hi.data_ptr(), col0.data_ptr(),
        nblk.data_ptr(), B, W, rows, gap_e, gap_oe, y_drop,
        int(trim_to_peak), tb_cap, y_drop_tail(y_drop, gap_e), _stream())
    build.check(rc, "ydrop_mega")
    build.count(ydrop_mega)
    st = {"CC": CC, "DD": DD}
    for i, k in enumerate(SCALAR_KEYS):
        st[k] = sc[:, i] != 0 if k in ("bflag", "done") else sc[:, i]
    return st, prev, pack_scalars(st, nblk), tb_all, row_lo, row_hi, col0


ydrop_mega.launches = 0


def traceback_mega(tb_all, row_lo, row_hi, col0, nblk, end1, end2, want,
                   cap: int):
    """The link-byte walk of every wanted lane (contract of
    ops/ydrop_exact.traceback_mega_plain): (ops (B, cap) uint8, n, row,
    col)."""
    if tb_all.device.type == "cpu":
        return traceback_mega_plain(tb_all, row_lo, row_hi, col0, nblk,
                                    end1, end2, want, cap)
    if tb_all.device.type != "cuda":
        raise ValueError(f"traceback_mega: unsupported device "
                         f"{tb_all.device}")
    B, K, R1, W = tb_all.shape
    dev = tb_all.device
    tb = tb_all.contiguous()
    lo, c0, nb = _i32(row_lo), _i32(col0), _i32(nblk)
    e1, e2 = _i32(end1), _i32(end2)
    wt = want.to(torch.uint8).contiguous()
    ops = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    n, row, col = (torch.empty(B, dtype=_I32, device=dev)
                   for _ in range(3))
    rc = build.load().ydrop_traceback_launch(
        tb.data_ptr(), lo.data_ptr(), c0.data_ptr(), nb.data_ptr(),
        e1.data_ptr(), e2.data_ptr(), wt.data_ptr(), ops.data_ptr(),
        n.data_ptr(), row.data_ptr(), col.data_ptr(), B, K, R1, W, cap,
        _stream())
    build.check(rc, "traceback_mega")
    build.count(traceback_mega)
    return ops, n, row, col


traceback_mega.launches = 0
