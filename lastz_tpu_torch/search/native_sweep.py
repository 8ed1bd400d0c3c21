"""Native sequential hit sweep: the whole seed-search stage (probe,
diagonal-hash protocol, x-drop extension, threshold) in one C call
per strand (native/ydrop_row.cpp hit_sweep; reference
private_hit_search/find_table_matches seed_search.c:464-810,
processors :1056/:1221, xdrop_extend_seed_hit :2528).

This is the HOST replay path at reference-C speed: the production
search runs on the accelerator (search/device_hits.py); the numpy
batched path (search/batched.py) remains the oracle and handles the
modes the native loop declines (twins, quantum, adaptive thresholds,
double scores).  The query scan rolls its seed window in C as well;
survivors come back with their query-position index so reports are
dispatched in the exact scalar order with the scalar's search-limit
granularity.
"""

from __future__ import annotations

import numpy as np

from ..config import GFEX_NO_EXTEND, GFEX_XDROP
from .batched import DIAG_HASH_SIZE, _probe_budgets, _probe_xors
from .replay import Replay

HASH_INACTIVE = -1


def supported(engine) -> bool:
    hp = engine.hp
    if engine.hit_mode not in ("simple", "recover"):
        return False
    if hp.gf_extend not in (GFEX_XDROP, GFEX_NO_EXTEND):
        return False
    if hp.pos_filter or hp.min_matches >= 0:
        return False
    if engine.seed.rev_comp:
        return False
    if engine.seed.type == "R" and getattr(
            engine.pt, "csr_resolve", None) is None:
        return False  # overweight seeds need the index resolve words
    if engine._native is None \
            or not hasattr(engine._native[0], "hit_sweep"):
        return False
    sub = engine._sub
    if hp.gf_extend == GFEX_XDROP:
        if sub is None or sub.dtype != np.int64:
            return False
        if hp.hsp_threshold.t != "S":
            return False  # adaptive thresholds: numpy path
        if engine.hit_mode == "recover":
            pass
    elif engine.hit_mode == "recover":
        return False  # no-extend recover differs; scalar handles
    return True


def _pt_native_arrays(pt):
    cached = getattr(pt, "_native_csr", None)
    if cached is not None:
        return cached
    csr_start = np.ascontiguousarray(pt.csr_start, dtype=np.int32)
    csr_pos = np.ascontiguousarray(pt.csr_pos, dtype=np.uint32)
    # nonempty-word bitmap: 1/8 byte per table word, so it stays
    # cache-resident while csr_start (4 bytes/word) does not
    bitmap = np.packbits(csr_start[1:] > csr_start[:-1],
                         bitorder="little")
    pt._native_csr = (csr_start, csr_pos, bitmap)
    return pt._native_csr


def native_hit_search(engine, start: int = 0, end: int = 0,
                      fresh_diag: bool = False):
    """Drop-in for SeedSearchEngine.search; returns bases_hit or None
    when this configuration is not supported.

    fresh_diag=True promises the diagonal-hash state (diag_end /
    diag_actual) is virgin for this call (the tweener resets it per
    window), so the overflow-rerun rewind can refill instead of
    snapshotting 1 MB per call."""
    if not supported(engine):
        return None
    if end == 0:
        end = len(engine.seq2)
    seed = engine.seed
    L = seed.length
    if end - start < L:
        return 0
    import ctypes

    from ..native import SweepCounters

    lib = engine._native[0]
    hp = engine.hp

    # seed-derived tables cached on the seed object: the tweener runs
    # this per 2 kb window, where re-deriving them dominated the call
    cached = getattr(seed, "_native_tables", None)
    if cached is None or cached[4] is not engine.char_to_bits:
        c2b = np.ascontiguousarray(engine.char_to_bits, np.int8)
        bm = np.asarray(seed.bit_map, np.int64).reshape(-1, 2)
        bm_src = np.ascontiguousarray(bm[:, 0])
        bm_dst = np.ascontiguousarray(bm[:, 1])
        xors = np.ascontiguousarray(_probe_xors(seed), dtype=np.int64)
        rm_src = np.ascontiguousarray(
            np.asarray(seed.resolve_bits, np.int64))
        budgets = np.ascontiguousarray(_probe_budgets(seed))
        cached = (c2b, bm_src, bm_dst, xors, engine.char_to_bits,
                  rm_src, budgets)
        seed._native_tables = cached
    c2b, bm_src, bm_dst, xors, _, rm_src, budgets = cached
    n_bm = len(bm_src)
    csr_resolve = None
    if seed.type == "R":
        csr_resolve = getattr(engine.pt, "_native_resolve", None)
        if csr_resolve is None:
            csr_resolve = np.ascontiguousarray(
                engine.pt.csr_resolve, dtype=np.uint32)
            engine.pt._native_resolve = csr_resolve
    if len(xors) > 264:          # native probe buffer cap
        return None

    pt = engine.pt
    if len(pt.csr_pos) >= (1 << 31):     # int32 CSR slots
        return None
    csr_start, csr_pos, wbitmap = _pt_native_arrays(pt)
    alive = pt.alive
    if alive is not None:
        alive = np.ascontiguousarray(alive, dtype=np.uint8)

    seq1 = np.ascontiguousarray(engine.seq1, dtype=np.uint8)
    seq2 = np.ascontiguousarray(engine.seq2, dtype=np.uint8)
    no_extend = hp.gf_extend == GFEX_NO_EXTEND
    if no_extend:
        sub = np.zeros((2, 2), np.int64)  # unused
        thresh = 0
        entropic = 0
        zero_thresh = 0
    else:
        sub = np.ascontiguousarray(engine._sub, dtype=np.int64)
        thresh = int(hp.hsp_threshold.s)
        entropic = 1 if hp.entropic_hsp else 0
        zero_thresh = int(hp.hsp_zero_threshold)

    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_u32 = ctypes.POINTER(ctypes.c_uint32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64

    de = engine.diag_end
    da = engine.diag_actual
    if fresh_diag:
        de_snap = da_snap = None
    else:
        de_snap = de.copy()
        da_snap = da.copy()

    # output capacity scaled to the scan size (a tiny tweener window
    # must not pay a 40 MB allocation); overflow reruns with room.
    # Buffers are reused across calls (the tweener makes one call per
    # 2 kb window).
    cap = int(min(1 << 20, max(4096, 2 * (end - start))))
    while True:
        out = getattr(engine, "_ns_out", None)
        if out is None or len(out["pos1"]) < cap:
            out = {k: np.empty(cap, np.int64)
                   for k in ("pos1", "pos2", "len", "score", "grp")}
            engine._ns_out = out
        else:
            cap = len(out["pos1"])
        res = SweepCounters()
        lib.hit_sweep(
            seq1.ctypes.data_as(p_u8), seq2.ctypes.data_as(p_u8),
            i64(len(seq1)), i64(len(seq2)),
            sub.ctypes.data_as(p_i64), i64(int(hp.x_drop)),
            i64(start), i64(end),
            c2b.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            i64(seed.bits_per_base),
            bm_src.ctypes.data_as(p_i64),
            bm_dst.ctypes.data_as(p_i64), i64(n_bm),
            rm_src.ctypes.data_as(p_i64),
            i64(len(rm_src) if csr_resolve is not None else 0),
            xors.ctypes.data_as(p_i64), i64(len(xors)),
            budgets.ctypes.data_as(p_i64),
            csr_start.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)),
            csr_pos.ctypes.data_as(p_u32),
            csr_resolve.ctypes.data_as(p_u32)
            if csr_resolve is not None
            else ctypes.cast(None, p_u32),
            wbitmap.ctypes.data_as(p_u8),
            alive.ctypes.data_as(p_u8) if alive is not None
            else ctypes.cast(None, p_u8),
            i64(int(pt.adj_start)), i64(int(pt.step)),
            de.ctypes.data_as(p_i64), da.ctypes.data_as(p_i64),
            i64(L),
            i64(1 if engine.self_compare else 0),
            i64(1 if engine.same_strand else 0),
            i64(int(engine.band_width)),
            i64(1 if engine.hit_mode == "recover" else 0),
            i64(1 if no_extend else 0),
            i64(thresh), i64(entropic), i64(zero_thresh),
            out["pos1"].ctypes.data_as(p_i64),
            out["pos2"].ctypes.data_as(p_i64),
            out["len"].ctypes.data_as(p_i64),
            out["score"].ctypes.data_as(p_i64),
            out["grp"].ctypes.data_as(p_i64),
            i64(cap), ctypes.byref(res))
        if res.n_out <= cap:
            break
        # overflow: rewind the diagonal state and rerun with room
        if fresh_diag:
            de.fill(HASH_INACTIVE)
            da.fill(0)
        else:
            de[:] = de_snap
            da[:] = da_snap
        cap = int(res.n_out) + 1024

    from .. import stats as _stats
    st = _stats.current
    n_pos = int(res.n_pos)
    st.words_in_queries += n_pos
    st.raw_seed_hits += int(res.raw_hits)
    st.hash_dropped_hits += int(res.dropped)
    st.ungapped_extensions += int(res.extensions)
    st.extra["ext_cycles"] = (st.extra.get("ext_cycles", 0)
                              + int(res.ext_cycles))
    st.extra["ext_steps"] = (st.extra.get("ext_steps", 0)
                             + int(res.ext_steps))

    n = int(res.n_out)
    rp = Replay(engine)
    if rp.report(zip(*(out[k][:n].tolist()
                       for k in ("grp", "pos1", "pos2", "len", "score")))):
        rp.stop(rp.trip_pos < n_pos - 1)
    return rp.bases_hit
