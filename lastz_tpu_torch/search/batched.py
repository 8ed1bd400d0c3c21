"""Batched seed search: vectorized hit-list generation + batched
x-drop extension + vectorized diagonal-hash replay.

Replaces the per-base probe loop of SeedSearchEngine.search
(reference private_hit_search, seed_search.c:464-579) for the common
configuration (simple hit processor, x-drop or no extension).  The
stages:

 1. BUILD (vectorized numpy): pack every query word, expand the
    transition-flip probe set, and expand the position-table CSR
    ranges into the full candidate hit list in EXACTLY the reference's
    enumeration order — query position ascending, probe order, target
    positions descending (the last/prev chain order).
 2. EXTEND (batched, ops/xdrop_batch.py): unblocked two-sided x-drop
    extension of every candidate: on the engine's device (K2) where
    lastz_tpu's device scan runs, else native C++ or vectorized numpy.
 3. RESOLVE (vectorized): the 64K diagonal-hash protocol
    (process_for_simple_hit, seed_search.c:1056-1198).  The key
    observation making this parallel: the per-diagonal extent state
    (diagEnd) advances with the RIGHT-scan block of each extended hit,
    which is independent of the left-scan block — so the whole
    per-hashed-diagonal chain is a segmented exclusive prefix-max over
    extents, with dropped hits excluded.  Drop decisions and extents
    are mutually dependent along each chain; a Jacobi fixpoint over
    segmented prefix-max passes converges in a few rounds (depth-d
    decisions are final after d rounds).
 4. REPORT (host): hits surviving the hash protocol are threshold-
    filtered vectorized (the entropy multiplier is <= 1, so raw score
    below a positive threshold can never pass), and the genuine HSP
    candidates become HSPs through search/replay.py, reported in the
    original order.

The scalar engine remains both the oracle and the fallback for the
exotic modes (recoverable/twin hits, quantum, overweight seeds,
positional/substitution filters, exact/mismatch extension).
"""

from __future__ import annotations


import numpy as np

from ..config import GFEX_NO_EXTEND, GFEX_XDROP
from ..index.postable import _window_words
from .replay import Replay

HASH_INACTIVE = -1
DIAG_HASH_SIZE = 65536
MIN64 = np.int64(-(1 << 62))


def supported(engine) -> bool:
    hp = engine.hp
    if engine.hit_mode not in ("simple", "recover", "twin"):
        return False
    if hp.gf_extend not in (GFEX_XDROP, GFEX_NO_EXTEND):
        return False
    if hp.pos_filter or hp.min_matches >= 0:
        return False
    if engine.seed.type == "R" and getattr(
            engine.pt, "csr_resolve", None) is None:
        # overweight seeds need the index's packed resolving words
        # (quantum/capsule-loaded tables may lack them)
        return False
    if engine.hit_mode in ("recover", "twin") \
            and hp.gf_extend != GFEX_XDROP:
        # without an extension the scalar processors' diagEnd/queue
        # updates differ; rare, keep scalar
        return False
    if engine.hit_mode == "twin" and hp.hsp_threshold.t != "S":
        # adaptive thresholds read the evolving anchor table during
        # entropy adjustment; deferred twin dispatch would skew it
        return False
    return True


def _probe_xors(seed):
    """The probe-word XOR sequence: exact word first, then transition
    flips in the reference's order (seed_search.c:464-579)."""
    xors = [0]
    if seed.with_trans >= 1:
        flips = list(seed.trans_flips)
        if seed.with_trans == 1:
            xors.extend(flips)
        else:
            for i, f in enumerate(flips):
                xors.append(f)
                for g in flips[i + 1:]:
                    xors.append(f ^ g)
    return np.array(xors, dtype=np.int64)


def _probe_budgets(seed):
    """Per-probe transition budget left for the RESOLVING bits, in
    _probe_xors order: flipped probes spend transition budget in the
    index, leaving less for the demoted bits
    (private_hit_search_resolve, seed_search.c:700-780)."""
    T = seed.with_trans
    buds = [T]
    if T >= 1:
        flips = list(seed.trans_flips)
        if T == 1:
            buds.extend([0] * len(flips))
        else:
            for i in range(len(flips)):
                buds.append(1)
                buds.extend([0] * (len(flips) - i - 1))
    return np.array(buds, dtype=np.int64)


def _gather_csr(engine, words):
    """Expand per-candidate-word CSR ranges into target positions in
    reference (descending last/prev) order.  Returns (cand_of_hit,
    pos1, csr_idx)."""
    pt = engine.pt
    csr_start = pt.csr_start
    starts = csr_start[words].astype(np.int64)
    ends = csr_start[words + 1].astype(np.int64)
    cnt = ends - starts
    total = int(cnt.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    grp = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
    cum = np.concatenate([[0], np.cumsum(cnt)])
    within = np.arange(total, dtype=np.int64) - cum[grp]
    csr_idx = ends[grp] - 1 - within  # descending = last/prev order
    if pt.alive is not None:
        keep = pt.alive[csr_idx]
        grp = grp[keep]
        csr_idx = csr_idx[keep]
    pos1 = pt.adj_start + pt.step * pt.csr_pos[csr_idx].astype(np.int64)
    return grp, pos1, csr_idx


def _filter_hits(engine, pos1, pos2, pidx):
    """Self-comparison / band filters (seed_search.c:841-847)."""
    L = engine.seed.length
    keep = np.ones(len(pos1), bool)
    if engine.self_compare:
        if engine.same_strand:
            keep &= pos1 < pos2
        else:
            p1 = pos1 - L
            p2 = (len(engine.seq2) - 1) - (pos2 - L)
            keep &= p1 < p2
    if engine.same_strand and engine.band_width > 0:
        keep &= (pos2 - pos1) <= engine.band_width
    if not keep.all():
        pos1 = pos1[keep]
        pos2 = pos2[keep]
        pidx = pidx[keep]
    return pos1, pos2, pidx


def _build_hits(engine, start, pos_lo, pos_hi):
    """Candidate hits for valid-word indices [pos_lo, pos_hi) of the
    window-word array, in reference order.  Returns (pos1, pos2,
    group) arrays; `group` indexes the valid-position list."""
    seed = engine.seed
    L = seed.length
    valid_idx = engine._batched_valid_idx
    packed_all = engine._batched_packed
    sel = valid_idx[pos_lo:pos_hi]
    packed = packed_all[sel].astype(np.int64)
    xors = engine._batched_xors
    nprobe = len(xors)
    wmat = (packed[:, None] ^ xors[None, :]).ravel()
    grp, pos1, csr_idx = _gather_csr(engine, wmat)
    if len(pos1) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    pidx = grp // nprobe  # index into sel
    if seed.type == "R":
        # overweight seeds: verify the demoted (resolving) bits of
        # each query window against the index's packed per-entry
        # words, within the probe's leftover transition budget
        # (seed_search.c:878-980; engine._probe_resolve)
        from .engine import _POPCOUNT16
        q_res = engine._batched_resolve[sel[pidx]].astype(np.uint32)
        xor = engine.pt.csr_resolve[csr_idx] ^ q_res
        mism = _POPCOUNT16[xor & 0xFFFF] + _POPCOUNT16[xor >> 16]
        keep = mism <= engine._batched_budgets[grp % nprobe]
        if not keep.all():
            pos1 = pos1[keep]
            pidx = pidx[keep]
    pos2 = start + L + sel[pidx]
    pos1, pos2, pidx = _filter_hits(engine, pos1, pos2, pidx)
    return pos1, pos2, pos_lo + pidx


def batched_search_quantum(engine, ball_score, start: int = 0,
                           end: int = 0):
    """Vectorized quantum-DNA seed search: the per-position ball
    expansion (quantum_seed_hit_search, quantum.c:128) runs as a flat
    level-by-level numpy expansion over position chunks, feeding the
    standard resolve/extend/report machinery.  Returns bases_hit, or
    None when unsupported (scalar replay takes over)."""
    hp = engine.hp
    seed = engine.seed
    if engine.hit_mode != "simple":
        return None
    if hp.gf_extend not in (GFEX_XDROP, GFEX_NO_EXTEND):
        return None
    if hp.pos_filter or hp.min_matches >= 0:
        return None
    if seed.type != "S" or seed.with_trans != 0:
        return None
    if end == 0:
        end = len(engine.seq2)
    L = seed.length
    n_pos = end - start - L + 1
    if n_pos <= 0:
        return 0

    # seed match-position layout (engine.search_quantum prologue)
    w = seed.weight // 2
    offsets = [None] * w
    for src, dst in seed.bit_map:
        if dst % 2 == 0:
            offsets[dst // 2] = L - 1 - src // 2
    if any(o is None for o in offsets):
        return None
    level_offsets = [offsets[w - 1 - i] for i in range(w)]
    ss = hp.scoring
    if ss is not None and not ss.rows_are_dna and ss.bottleneck:
        sym_codes = np.frombuffer(
            ss.bottleneck, dtype=np.uint8).astype(np.int64)
    else:
        sym_codes = np.frombuffer(
            b"ACGT", dtype=np.uint8).astype(np.int64)
    if len(sym_codes) != 4:
        return None
    sub = engine._sub
    four = np.arange(4, dtype=np.int64)

    def build(engine, start_, pos_lo, pos_hi):
        qpe = start_ + L + np.arange(pos_lo, pos_hi, dtype=np.int64)
        P = len(qpe)
        # (P, 4) citizen scores per level
        lvl = [np.ascontiguousarray(
                   sub[np.ix_(sym_codes, engine.seq2[qpe - L + off])].T)
               for off in level_offsets]
        best = np.stack([l.max(axis=1) for l in lvl], axis=1)
        minneed = np.empty((P, w), sub.dtype)
        minneed[:, w - 1] = ball_score
        for i in range(w - 1, 0, -1):
            minneed[:, i - 1] = minneed[:, i] - best[:, i]
        posidx = np.nonzero(best.sum(axis=1) >= ball_score)[0]
        packed = np.zeros(len(posidx), np.int64)
        score = np.zeros(len(posidx), sub.dtype)
        # level-by-level 4-way expansion; order stays (position asc,
        # packed word asc) = the reference DFS enumeration order
        for i in range(w):
            if len(packed) == 0:
                break
            packed = (packed[:, None] * 4 + four).ravel()
            score = (score[:, None] + lvl[i][posidx]).ravel()
            posidx = np.repeat(posidx, 4)
            keep = score >= minneed[posidx, i]
            packed = packed[keep]
            score = score[keep]
            posidx = posidx[keep]
        if len(packed) == 0:
            z = np.zeros(0, np.int64)
            return z, z, z
        grp, pos1, _ = _gather_csr(engine, packed)
        if len(pos1) == 0:
            z = np.zeros(0, np.int64)
            return z, z, z
        pidx = posidx[grp]
        pos2 = start_ + L + (pos_lo + pidx)
        pos1, pos2, pidx = _filter_hits(engine, pos1, pos2, pidx)
        return pos1, pos2, pos_lo + pidx

    return batched_search(engine, start, end, _builder=build,
                          _n_pos=n_pos)


def _seg_cummax_exclusive(x, seg_start):
    """Exclusive prefix max along segments (log-doubling).  x int64,
    seg_start bool marking the first element of each segment."""
    n = len(x)
    out = np.full(n, MIN64)
    out[1:] = x[:-1]
    out[seg_start] = MIN64
    # blocked[i]: the prefix ending at i may not cross a segment start
    dist = np.arange(n, dtype=np.int64)
    # seg_id via cumsum of starts
    seg_id = np.cumsum(seg_start) - 1
    shift = 1
    while shift < n:
        cand = np.full(n, MIN64)
        cand[shift:] = out[:-shift]
        ok = np.zeros(n, bool)
        ok[shift:] = seg_id[shift:] == seg_id[:-shift]
        np.maximum(out, np.where(ok, cand, MIN64), out=out)
        shift *= 2
    return out


def _resolve_chains(extent, pos2mL, de0, seg_start, max_rounds=64):
    """Fixpoint of the diagonal-hash drop protocol along each hashed-
    diagonal chain: a hit is dropped when the extent state before it
    (de0 joined with the running max of PREVIOUS undropped extents)
    exceeds pos2 - seedLength.  Returns (alive, de_before) or None
    when unconverged (caller falls back to the scalar engine)."""
    n = len(extent)
    alive = np.ones(n, bool)
    for _ in range(max_rounds):
        contrib = np.where(alive, extent, MIN64)
        run = _seg_cummax_exclusive(contrib, seg_start)
        de_before = np.maximum(run, de0)
        dropped = de_before > pos2mL
        new_alive = ~dropped
        if np.array_equal(new_alive, alive):
            return alive, de_before
        alive = new_alive
    return None


def _resolve_chains_recover(extent, start2, diag, de0, dact0,
                            seg_start):
    """Chain scan for --recoverseeds (process_for_recoverable_hit,
    seed_search.c:1221-1420): a hit whose hashed diagonal was already
    extended past it is dropped only when diagActual matches its TRUE
    diagonal; a collision with a different diagonal is accepted with
    an unblocked left extension.  All chains advance in lockstep, one
    hit per step, vectorized over the chains present in the chunk.

    Returns (alive, left_block, unblocked, final_de, final_dact);
    final_* are per-chain end-of-chunk states in seg_start order."""
    n = len(extent)
    starts = np.nonzero(seg_start)[0]
    lens = np.diff(np.concatenate([starts, [n]]))
    cur = de0[starts].copy()          # may be HASH_INACTIVE
    curd = dact0[starts].copy()
    alive = np.ones(n, bool)
    left_block = np.zeros(n, np.int64)
    unblocked = np.zeros(n, bool)
    for r in range(int(lens.max())):
        act = r < lens
        idx = starts + np.where(act, r, 0)
        t = start2[idx]
        e = extent[idx]
        dg = diag[idx]
        inactive = cur == HASH_INACTIVE
        cur0 = np.where(inactive, 0, cur)
        curd0 = np.where(inactive, dg, curd)
        covered = (cur0 > t) & ~inactive
        drop = covered & (curd0 == dg)
        unb = covered & (curd0 != dg)
        ok = ~drop
        w = idx[act]
        alive[w] = ok[act]
        left_block[w] = np.where(unb, 0, cur0)[act]
        unblocked[w] = unb[act]
        # extension happens for every accepted hit and records the
        # right-scan block (engine._xdrop_extend:637-642) — even when
        # the HSP itself is discarded below threshold
        upd = act & ok & (e > cur0)
        cur = np.where(act, np.where(upd, e, cur0), cur)
        curd = np.where(act, np.where(upd, dg, curd0), curd)
    return alive, left_block, unblocked, cur, curd


def batched_search(engine, start: int = 0, end: int = 0,
                   _builder=None, _n_pos=None):
    """Drop-in replacement for SeedSearchEngine.search; returns
    bases_hit, or None when this configuration is not supported.
    _builder/_n_pos inject an alternative candidate generator over
    the same chunked resolve/extend/report machinery (quantum)."""
    if _builder is None and not supported(engine):
        return None
    if end == 0:
        end = len(engine.seq2)
    seed = engine.seed
    L = seed.length
    if end - start < L:
        return 0

    if _builder is None:
        codes = engine.char_to_bits[engine.seq2[start:end]]
        words, valid = _window_words(codes, L, seed.bits_per_base)
        engine._batched_packed = seed.pack(words)
        engine._batched_valid_idx = np.nonzero(valid)[0]
        engine._batched_xors = _probe_xors(seed)
        if seed.type == "R":
            engine._batched_resolve = seed.pack_resolve(words)
            engine._batched_budgets = _probe_budgets(seed)
        n_pos = len(engine._batched_valid_idx)
        build = _build_hits
    else:
        n_pos = _n_pos
        build = _builder
    if n_pos == 0:
        return 0

    hp = engine.hp
    x_drop = hp.x_drop
    sub = engine._sub
    no_extend = hp.gf_extend == GFEX_NO_EXTEND
    # the device x-drop (K2), where lastz_tpu's batch_xdrop_jax runs with
    # its device on (lastz_tpu/search/batched.py:414-425)
    on_device = (engine.device is not None and not no_extend
                 and sub is not None and sub.dtype == np.int64
                 and np.abs(sub).max() < (1 << 31)
                 and max(len(engine.seq1), len(engine.seq2)) < (1 << 31))
    if on_device:
        from ..ops.xdrop_batch import batch_xdrop_device, device_codes
        codes = device_codes(engine.seq1, engine.seq2, sub, engine.device)
    elif not no_extend:
        from ..ops.xdrop_batch import batch_xdrop_native, batch_xdrop_np
        native_lib = None
        if (sub is not None and sub.dtype == np.int64
                and engine._native is not None
                and hasattr(engine._native[0], "xdrop_scan_batch")):
            native_lib = engine._native[0]
        precoded = None
        if native_lib is None and sub is not None \
                and sub.dtype == np.int64 \
                and np.abs(sub).max() < (1 << 31):
            from ..ops.ydrop_exact import make_compact_alphabet
            cmap = make_compact_alphabet(
                [engine.seq1, engine.seq2], sub, max_k=16)
            if cmap is not None:
                code_map, subsmall = cmap
                precoded = (code_map[engine.seq1].astype(np.int8),
                            code_map[engine.seq2].astype(np.int8),
                            np.ascontiguousarray(
                                subsmall.reshape(-1)),
                            subsmall.shape[0])

    from .. import stats as _stats
    st = _stats.current
    st.words_in_queries += n_pos
    POS_CHUNK = 1 << 20
    de = engine.diag_end
    da = engine.diag_actual
    thresh_is_score = hp.hsp_threshold.t == "S"
    thresh = hp.hsp_threshold.s
    seq1 = engine.seq1
    seq2 = engine.seq2

    twin = engine.hit_mode == "twin"
    if twin:
        from . import twins as _twins
        twin_snap = _twins.snapshot(engine)
    # twins report once the whole search has resolved
    rp = Replay(engine, defer=twin, restore=True)

    for pos_lo in range(0, n_pos, POS_CHUNK):
        pos_hi = min(pos_lo + POS_CHUNK, n_pos)
        pos1a, pos2a, grp = build(engine, start, pos_lo, pos_hi)
        H = len(pos1a)
        if H == 0:
            continue
        diag_a = pos1a - pos2a
        h_a = (diag_a & (DIAG_HASH_SIZE - 1)).astype(np.int64)

        if no_extend:
            ext = None
            extent = pos2a
        else:
            if on_device:
                ext = batch_xdrop_device(seq1, seq2, sub, pos1a, pos2a,
                                         x_drop, engine.device, codes)
            elif native_lib is not None:
                ext = batch_xdrop_native(seq1, seq2, sub, pos1a,
                                         pos2a, x_drop, native_lib)
            else:
                ext = batch_xdrop_np(seq1, seq2, sub, pos1a, pos2a,
                                     x_drop, precoded=precoded)
            extent = pos1a + ext["right_consumed"] - diag_a

        # chain resolution per hashed diagonal
        order = np.argsort(h_a, kind="stable")
        hs = h_a[order]
        seg_start = np.ones(H, bool)
        seg_start[1:] = hs[1:] != hs[:-1]
        seg_first = np.nonzero(seg_start)[0]
        touched_h = hs[seg_first]
        recover = engine.hit_mode == "recover"
        if twin:
            try:
                outcome_s, de_before_s = _twins.resolve_chunk(
                    engine, extent[order], pos2a[order],
                    diag_a[order], hs, order, seg_start, L)
            except _twins.TwinOverflow:
                # queue aging / ring depth would diverge from the
                # reference; rewind and let the scalar engine replay
                _twins.restore(engine, twin_snap)
                return None
            alive_s = outcome_s == _twins.OUT_FOUND
        elif recover:
            de0_raw = de[hs]  # HASH_INACTIVE kept distinct
            alive_s, lb_s, _, fin_de, fin_da = _resolve_chains_recover(
                extent[order], (pos2a - L)[order], diag_a[order],
                de0_raw, da[hs], seg_start)
            de_before_s = lb_s
            de[touched_h] = fin_de
            da[touched_h] = fin_da
        else:
            de0 = de[hs]
            de0 = np.where(de0 == HASH_INACTIVE, 0, de0)
            res = _resolve_chains(extent[order], (pos2a - L)[order],
                                  de0, seg_start)
            if res is None:
                return None  # pathological; scalar engine takes over
            alive_s, de_before_s = res
            # advance the diagonal state to end-of-chunk values
            contrib = np.where(alive_s, extent[order], MIN64)
            seg_max = np.maximum.reduceat(
                np.maximum(contrib, de0), seg_first)
            de[touched_h] = np.maximum(de[touched_h], seg_max)
            de[touched_h] = np.where(
                de[touched_h] == HASH_INACTIVE, 0, de[touched_h])
        alive = np.zeros(H, bool)
        alive[order] = alive_s
        de_before = np.zeros(H, np.int64)
        de_before[order] = de_before_s

        if no_extend:
            bind = np.zeros(H, bool)
            cand_mask = alive
        else:
            lc = ext["left_consumed"]
            stop1_blk = np.maximum(de_before + diag_a, 0)
            bind = alive & (lc > pos1a - stop1_blk)
            sim_raw = ext["left_score"] + ext["right_score"]
            if thresh_is_score and thresh > 0:
                # entropy multiplier <= 1: below-threshold raw scores
                # can never pass, drop them vectorized
                cand_mask = alive & (bind | (sim_raw >= thresh))
            else:
                cand_mask = alive

        st.raw_seed_hits += H
        st.hash_dropped_hits += int((~alive).sum())
        st.ungapped_extensions += int(alive.sum())

        cand = np.flatnonzero(cand_mask)
        scores = [np.zeros(len(cand), np.int64) if no_extend
                  else ext[k][cand].astype(np.int64) for k in (
                      "left_score", "left_start", "right_score",
                      "right_stop")]
        ok = rp.rows(pos1a[cand], pos2a[cand], grp[cand], *scores,
                     de_before[cand], bind[cand])
        if not ok or rp.stop(pos_hi < n_pos):
            return rp.bases_hit

    if twin and not rp.flush():
        return rp.bases_hit
    rp.stop(rp.trip_pos < n_pos - 1)
    return rp.bases_hit
