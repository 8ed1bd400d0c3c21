"""Batched twin-hit resolution (--twins).

Reference semantics: process_for_twin_hit + the cyclic seed-hit queue
(seed_search.c:1526-1710, diag_hash.c/_enqueue_seed_hit,
diag_hash.h:106-145).  A hit is only extended once a SECOND hit lands
on the same true diagonal with span in [minSpan, maxSpan]; recent
hits are remembered in a 256K-entry global queue threaded per hashed
diagonal, and extension ends are remembered as "block" entries that
suppress overlapping re-extension.  Hash collisions are observable:
the walk over a hashed diagonal's entries terminates at the first
entry (of ANY true diagonal) whose span exceeds maxSpan.

Batched design: hits are sorted by hashed diagonal (chains); all
chains advance in LOCKSTEP, one hit per step, with each chain's
recent-entry tail held in a fixed ring of TWIN_RING entries gathered
from per-hash state arrays.  The walk over ring entries is an inner
vectorized loop (newest first), reproducing the reference's decision
order exactly.  Two effects cannot be decided chain-locally and are
validated after the fact, falling back to the scalar engine when
violated (TwinOverflow):

  * queue AGING — the reference hides entries older than the last
    queue-size enqueues; enqueue numbers depend on outcomes across
    all chains, so the scan assumes no aging and then checks that no
    examined entry would actually have been hidden;
  * ring OVERFLOW — a walk that exhausts the stored tail of a chain
    that has already dropped older entries cannot know whether the
    reference would have walked further.

Because a bail can happen after earlier chunks were processed, the
caller snapshots the twin/diagonal state at search start and defers
all report dispatch to the end of the search.
"""

from __future__ import annotations

import numpy as np

HASH_INACTIVE = -1
DIAG_HASH_SIZE = 65536

TWIN_RING = 32

# outcomes
OUT_ACTIVATE = 0   # first hit on an inactive hashed diagonal
OUT_NOTFOUND = 1   # no twin yet: remember the hit
OUT_OVERLAP = 2    # overlaps a previous extension's block entry
OUT_FOUND = 3      # twin found: extend and report

_BIG = np.int64(1 << 62)


class TwinOverflow(Exception):
    """Batched twin resolution cannot reproduce the reference's queue
    semantics for this input; the scalar engine must replay."""


def ensure_state(engine):
    if hasattr(engine, "_twb_pos2"):
        return
    K = TWIN_RING
    H = DIAG_HASH_SIZE
    engine._twb_pos2 = np.zeros((H, K), np.int64)
    engine._twb_diag = np.zeros((H, K), np.int64)
    engine._twb_block = np.zeros((H, K), bool)
    engine._twb_num = np.zeros((H, K), np.int64)
    engine._twb_head = np.zeros(H, np.int32)
    engine._twb_cnt = np.zeros(H, np.int32)
    engine._twb_dropped = np.zeros(H, bool)
    # matches the scalar engine: first enqueue gets number n+1
    engine._twb_hitnum = int(engine.SEED_HIT_QUEUE_SIZE)


_STATE_KEYS = ("_twb_pos2", "_twb_diag", "_twb_block", "_twb_num",
               "_twb_head", "_twb_cnt", "_twb_dropped")


def snapshot(engine):
    ensure_state(engine)
    snap = {k: getattr(engine, k).copy() for k in _STATE_KEYS}
    snap["_twb_hitnum"] = engine._twb_hitnum
    snap["diag_end"] = engine.diag_end.copy()
    snap["diag_actual"] = engine.diag_actual.copy()
    return snap


def restore(engine, snap):
    for k in _STATE_KEYS:
        setattr(engine, k, snap[k])
    engine._twb_hitnum = snap["_twb_hitnum"]
    engine.diag_end[:] = snap["diag_end"]
    engine.diag_actual[:] = snap["diag_actual"]


def resolve_chunk(engine, extent_s, pos2_s, diag_s, hs, orig_s,
                  seg_start, L):
    """Advance the twin protocol over one chunk's hash-sorted hits.

    extent_s/pos2_s/diag_s: per sorted hit; hs: hashed diagonal per
    sorted hit; orig_s: original (report-order) index per sorted hit;
    seg_start: chain-start marks.  Mutates the engine's twin state
    and diag_end.  Returns (outcome, de_before) in SORTED order.
    Raises TwinOverflow when exactness cannot be guaranteed."""
    ensure_state(engine)
    K = TWIN_RING
    qsize = int(engine.SEED_HIT_QUEUE_SIZE)
    min_span = int(engine.twin_min_span)
    max_span = int(engine.twin_max_span)
    n = len(extent_s)
    starts = np.nonzero(seg_start)[0]
    lens = np.diff(np.concatenate([starts, [n]]))
    h_of = hs[starts]

    rp2 = engine._twb_pos2[h_of].copy()
    rdg = engine._twb_diag[h_of].copy()
    rbk = engine._twb_block[h_of].copy()
    rnum = engine._twb_num[h_of].copy()
    head = engine._twb_head[h_of].astype(np.int64)
    cnt = engine._twb_cnt[h_of].astype(np.int64)
    dropped = engine._twb_dropped[h_of].copy()
    de = engine.diag_end[h_of].astype(np.int64)

    outcome = np.full(n, OUT_NOTFOUND, np.int8)
    de_before = np.zeros(n, np.int64)
    adv = np.zeros(n, bool)          # FOUND hits that push a block
    min_ex_num = np.full(n, _BIG)    # oldest persisted entry examined
    min_ex_loc = np.full(n, 1 << 62) # oldest chunk-local entry (orig i)

    nch = len(starts)
    lanes = np.arange(nch)
    for r in range(int(lens.max())):
        act = r < lens
        s_idx = starts + np.where(act, r, 0)
        p2 = pos2_s[s_idx]
        dg = diag_s[s_idx]
        ex = extent_s[s_idx]
        start2 = p2 - L

        inactive = de == HASH_INACTIVE
        decided = ~act | inactive
        out_r = np.where(inactive, OUT_ACTIVATE, OUT_NOTFOUND
                         ).astype(np.int8)
        found = np.zeros(nch, bool)
        overlap = np.zeros(nch, bool)
        walked_all = np.zeros(nch, bool)
        mnum = np.full(nch, _BIG)
        mloc = np.full(nch, 1 << 62)
        for t in range(K):
            has = (~decided) & (t < cnt)
            if not has.any():
                walked_all |= ~decided & (t >= cnt)
                break
            slot = (head - 1 - t) % K
            qp2 = rp2[lanes, slot]
            qdg = rdg[lanes, slot]
            qbk = rbk[lanes, slot]
            qnm = rnum[lanes, slot]
            span = p2 - (qp2 - L)
            pers = qnm >= 0
            mnum = np.where(has & pers, np.minimum(mnum, qnm), mnum)
            mloc = np.where(has & ~pers,
                            np.minimum(mloc, -qnm - 2), mloc)
            br_max = span > max_span
            same_dg = qdg == dg
            blk_overlap = qbk & (start2 <= qp2)
            blk_break = qbk & ~blk_overlap
            small = span < min_span
            # decision for lanes reaching this entry
            dec_break = br_max | (same_dg & (blk_overlap | blk_break))
            dec_found = (~br_max) & same_dg & (~qbk) & (~small)
            ov = has & (~br_max) & same_dg & blk_overlap
            fo = has & dec_found
            overlap |= ov
            found |= fo
            decided = decided | (has & (dec_break | dec_found))
            walked_all |= (~decided) & (t + 1 >= cnt)
        # lanes that exhausted the stored tail of a wrapped ring
        if np.any(act & walked_all & ~found & ~overlap & dropped):
            raise TwinOverflow("twin walk exhausted stored ring tail")
        out_r = np.where(found, OUT_FOUND, out_r)
        out_r = np.where(overlap, OUT_OVERLAP, out_r)

        # state transition
        de_b = np.where(inactive, 0, de)
        adv_r = found & (ex > de_b)
        new_de = np.where(inactive, 0, np.where(adv_r, ex, de))
        enq_hit = act & ((out_r == OUT_ACTIVATE)
                         | (out_r == OUT_NOTFOUND))
        enq_blk = act & adv_r
        do_enq = enq_hit | enq_blk
        wslot = head % K
        rp2[lanes[do_enq], wslot[do_enq]] = \
            np.where(enq_blk, ex, p2)[do_enq]
        rdg[lanes[do_enq], wslot[do_enq]] = dg[do_enq]
        rbk[lanes[do_enq], wslot[do_enq]] = enq_blk[do_enq]
        rnum[lanes[do_enq], wslot[do_enq]] = \
            -(orig_s[s_idx][do_enq].astype(np.int64)) - 2
        head = np.where(do_enq, head + 1, head)
        dropped |= do_enq & (cnt == K)
        cnt = np.where(do_enq, np.minimum(cnt + 1, K), cnt)
        de = np.where(act, new_de, de)

        w = s_idx[act]
        outcome[w] = out_r[act]
        de_before[w] = de_b[act]
        adv[w] = adv_r[act]
        min_ex_num[w] = mnum[act]
        min_ex_loc[w] = mloc[act]

    # ---- enqueue numbering + aging validation (report order) ------
    enq_flag = np.zeros(n, np.int64)
    enq_flag[(outcome == OUT_ACTIVATE) | (outcome == OUT_NOTFOUND)] = 1
    enq_flag[adv] = 1
    enq_in_orig = np.zeros(n, np.int64)
    enq_in_orig[orig_s] = enq_flag
    cum = np.cumsum(enq_in_orig)  # inclusive, original order
    n0 = engine._twb_hitnum
    probe_num = np.empty(n, np.int64)  # seed_hit_num at probe, orig order
    probe_num[0] = n0
    probe_num[1:] = n0 + cum[:-1]

    pn_s = probe_num[orig_s]
    bad = min_ex_num < pn_s - qsize
    loc_ex = min_ex_loc < (1 << 62)
    loc_num = np.where(loc_ex, n0 + cum[np.minimum(min_ex_loc, n - 1)],
                       _BIG)
    bad |= loc_ex & (loc_num < pn_s - qsize)
    if bad.any():
        raise TwinOverflow("twin queue aging would hide an entry")

    # ---- writeback -------------------------------------------------
    local = rnum < 0
    if local.any():
        idx = (-rnum - 2).astype(np.int64)
        rnum = np.where(local, n0 + cum[np.clip(idx, 0, n - 1)], rnum)
    engine._twb_pos2[h_of] = rp2
    engine._twb_diag[h_of] = rdg
    engine._twb_block[h_of] = rbk
    engine._twb_num[h_of] = rnum
    engine._twb_head[h_of] = (head % K).astype(np.int32)
    engine._twb_cnt[h_of] = cnt.astype(np.int32)
    engine._twb_dropped[h_of] = dropped
    engine.diag_end[h_of] = de
    engine._twb_hitnum = int(n0 + cum[-1])
    return outcome, de_before
