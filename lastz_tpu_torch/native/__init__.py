"""Native (C++) runtime kernels for the exact host engine.

Compiled on first use with g++ into a shared library cached in
lastz_tpu_torch/build/ (named by a hash of the sources and flags) and
loaded via ctypes.  Everything here is an exact-speedup of the Python engine;
if no compiler is available the Python paths are used instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_LIB = None
_TRIED = False

_SRCS = [
    os.path.join(os.path.dirname(__file__), "ydrop_row.cpp"),
    os.path.join(os.path.dirname(__file__), "chain_kd.cpp"),
]


class SweepCounters(ctypes.Structure):
    _fields_ = [
        ("n_out", ctypes.c_int64),
        ("raw_hits", ctypes.c_int64),
        ("dropped", ctypes.c_int64),
        ("extensions", ctypes.c_int64),
        ("n_pos", ctypes.c_int64),
        ("ext_cycles", ctypes.c_int64),
        ("ext_steps", ctypes.c_int64),
    ]


class SweepResult(ctypes.Structure):
    _fields_ = [
        ("score", ctypes.c_int64),
        ("end1", ctypes.c_int64),
        ("end2", ctypes.c_int64),
        ("truncated", ctypes.c_int64),
        ("n_ops", ctypes.c_int64),
        ("tbp", ctypes.c_int64),
        # cycle buckets, filled only under LASTZ_TORCH_SWEEP_PROF=1
        ("n_rows", ctypes.c_int64),
        ("cy_srow", ctypes.c_int64),
        ("cy_row", ctypes.c_int64),
        ("cy_other", ctypes.c_int64),
        ("overflow", ctypes.c_int64),
    ]


class RowResult(ctypes.Structure):
    _fields_ = [
        ("LY", ctypes.c_int64),
        ("np_col", ctypes.c_int64),
        ("i_val", ctypes.c_int64),
        ("best_score", ctypes.c_int64),
        ("end1", ctypes.c_int64),
        ("end2", ctypes.c_int64),
        ("end_is_boundary", ctypes.c_int64),
        ("boundary_score", ctypes.c_int64),
        ("dq", ctypes.c_int64),
        ("tbp", ctypes.c_int64),
    ]


def _build_lib() -> str | None:
    h = hashlib.sha256()
    for src_path in _SRCS:
        with open(src_path, "rb") as f:
            h.update(f.read())
    h.update(b"-O3 -march=native")  # flags are part of the cache key
    tag = h.hexdigest()[:16]
    cache_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(cache_dir, exist_ok=True)
    lib_path = os.path.join(cache_dir, f"libydrop_{tag}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           *_SRCS, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        return None
    os.replace(tmp, lib_path)
    return lib_path


def get_lib():
    """Return the loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_u32 = ctypes.POINTER(ctypes.c_uint32)
    lib.ydrop_row.restype = None
    lib.ydrop_row.argtypes = [
        p_i64, p_i64, p_i64,      # CC, DD, MASK
        p_u8,                     # tb
        p_i64,                    # sub_row
        p_u8, i64, i64,           # B, b_origin, b_step
        i64, i64, i64,            # row, M, N
        i64, i64, i64,            # LY, RY, prev_LY
        i64, i64, i64,            # gap_e, gap_oe, y_drop
        i64,                      # neg_inf
        i64, i64, i64,            # best_score, end1, end2
        i64, i64,                 # end_is_boundary, boundary_score
        i64, i64,                 # trim_to_peak, have_active
        i64,                      # tbp
        ctypes.POINTER(RowResult),
    ]
    lib.ydrop_sweep.restype = None
    lib.ydrop_sweep.argtypes = [
        p_u8, p_u8,               # v1, v2
        p_i64,                    # sub (256x256)
        i64, i64, i64, i64,       # a_origin, a_step, b_origin, b_step
        i64, i64,                 # M, N
        i64, i64, i64, i64,       # gap_e, gap_oe, y_drop, y_drop_tail
        i64, i64,                 # neg_inf, trim_to_peak
        p_i64, i64,               # lrec, n_lrec
        p_i64, i64,               # rrec, n_rrec
        p_i64, p_i64, p_i64, i64, # act_row, seg_off, seg_cnt, n_acts
        p_i64,                    # segs
        p_u8, i64,                # tb, tb_cap
        p_u8,                     # ops_out
        ctypes.POINTER(SweepResult),
    ]
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i8 = ctypes.POINTER(ctypes.c_int8)
    lib.build_postable.restype = i64
    lib.build_postable.argtypes = [
        p_u8, i64, i64,           # seq, start, end
        p_i8, i64, i64,           # char2bits, L, bits_per
        p_i64, p_i64, i64,        # bm_src, bm_dst, n_bm
        i64, i64, i64,            # step, adj_start, num_words
        p_i32, p_u32,             # csr_start, out_pos
    ]
    lib.csr_fill.restype = None
    lib.csr_fill.argtypes = [p_u32, i64, i64, p_i32]
    lib.hit_sweep.restype = None
    lib.hit_sweep.argtypes = [
        p_u8, p_u8, i64, i64,     # s1, s2, len1, len2
        p_i64, i64,               # sub, x_drop
        i64, i64,                 # start, end (query interval)
        p_i8, i64,                # char2bits, bits_per
        p_i64, p_i64, i64,        # bm_src, bm_dst, n_bm
        p_i64, i64,               # rm_src, n_rm (resolving bits)
        p_i64, i64,               # xors, nx
        p_i64,                    # probe_budget (per probe)
        p_i32, p_u32,             # csr_start, csr_pos
        p_u32,                    # csr_resolve (or None)
        p_u8,                     # word-nonempty bitmap
        p_u8,                     # alive (or None)
        i64, i64,                 # adj_start, step
        p_i64, p_i64, i64,        # de, da, seed_len
        i64, i64, i64,            # self_compare, same_strand, band
        i64, i64,                 # hit_mode, no_extend
        i64, i64, i64,            # thresh, entropic, zero_thresh
        p_i64, p_i64, p_i64, p_i64, p_i64, i64,  # outputs, cap
        ctypes.POINTER(SweepCounters),
    ]
    lib.xdrop_scan_batch.restype = None
    lib.xdrop_scan_batch.argtypes = [
        p_u8, p_u8, p_i64,        # s1, s2, sub (256x256)
        i64, i64, i64,            # len1, len2, x_drop
        p_i64, p_i64, i64,        # pos1, pos2, H
        p_i64, p_i64, p_i64,      # lc, ls, lstart
        p_i64, p_i64, p_i64,      # rc, rs, rstop
    ]
    lib.ydrop_bench.restype = ctypes.c_int64
    lib.ydrop_bench.argtypes = [
        p_i64, p_i64, p_i64, p_u8, p_i64, p_u8,
        i64, i64, i64, i64, i64, i64,
    ]
    lib.xdrop_extend.restype = None
    lib.xdrop_extend.argtypes = [
        p_u8, p_u8, p_i64,
        i64, i64, i64, i64, i64,
        p_i64, p_i64, p_i64, p_i64, p_i64,
    ]
    f64 = ctypes.c_double
    p_f64 = ctypes.POINTER(ctypes.c_double)
    lib.chain_reduce.restype = None
    lib.chain_reduce.argtypes = [
        i64,                       # n
        p_i64, p_i64, p_i64,       # pos1, pos2, length
        p_f64,                     # score
        f64, f64, f64, f64, f64,   # scale, diagPen, antiPen, subPen, clip
        p_f64, p_i64,              # chain_score_out, back_out
    ]
    _LIB = lib
    return _LIB
