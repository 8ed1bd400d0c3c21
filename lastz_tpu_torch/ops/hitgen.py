"""Device seed-hit generation: the SEED->HSP stage of the reference
(private_hit_search + find_table_matches + the simple and recoverable
hit processors + x-drop extension, seed_search.c:464-1420,2528) as a
few torch programs and two kernels, so the raw candidate hit list never
crosses to the host.  Port of lastz_tpu/ops/hitgen.py.

  pack_query_words   query 2-bit codes -> packed seed words (:66)
  pair_counts        CSR probe counts and their prefix sum (:95)
  expand_chunk       pair index of every hit in a chunk (:111)
  xdrop_scan_plain   the gap-free x-drop scan of _xdrop_all (:182),
                     the CPU path of ops/xdrop_cuda.xdrop_scan and the
                     oracle of csrc/xdrop_scan.cu
  chain_bounds, _resolve_chains, _resolve_chains_recover
                     the diagonal-hash chain walks (:345-468), the CPU
                     path of ops/resolve_cuda.resolve_chains and the
                     oracle of csrc/resolve_chains.cu
  hit_launch         one fixed-budget slice of the candidate hits
                     (:482-654), simple or recover hit mode, with the
                     overweight seeds' resolving-bit test

Seed words are int64 (torch on the CPU has no `>>` on uint32); scores
and positions stay int32 where JAX keeps them int32.
"""

from __future__ import annotations

import torch

from ..device import SEQ_PAD

DIAG_HASH_SIZE = 65536
MIN32 = -(1 << 30)
HIT_BUDGET = 1 << 22      # candidate hits per launch
OUT_CAP = 1 << 18         # max survivors per launch
XD_SLICE = 1 << 15        # hits per plain x-drop slice
XD_FIRST = 64             # cells in the plain scan's first round
XD_CHUNK = 256            # cells per later round
RESOLVE_CHAIN_CAP = 16384  # longest chain walked on device

_I32 = torch.int32
_I64 = torch.int64


def pack_query_words(codes, bit_map, length: int, bits_per: int):
    """codes: (n,) int8 2-bit codes (-1 invalid).  Returns (packed
    int64 (n-L+1,), valid bool); window k ENDS at base index L-1+k."""
    n = codes.shape[0]
    num = n - length + 1
    c = codes.to(_I64)
    cb = torch.cumsum((c < 0).to(_I64), 0)
    head = cb[length - 1: length - 1 + num]
    tail = torch.cat([cb.new_zeros(1), cb[: num - 1]])
    valid = (head - tail) == 0
    packed = torch.zeros(num, dtype=_I64, device=codes.device)
    for src, dst in bit_map:
        base_ix = length - 1 - src // bits_per
        seg = c[base_ix: base_ix + num]
        packed |= ((seg >> (src % bits_per)) & 1) << dst
    return packed, valid


def pair_counts(packed, valid, xors, csr_start):
    """Returns (cum (P*nprobe+1,) exclusive prefix sum of per
    (position, probe) candidate counts, ends (P*nprobe,) CSR end
    offsets, total as a 0-d tensor)."""
    words = (packed[:, None] ^ xors[None, :]).reshape(-1)
    nw = csr_start.shape[0] - 1
    w = torch.clamp(words, max=nw - 1)
    ends = csr_start[w + 1].to(_I64)
    cnt = ends - csr_start[w].to(_I64)
    cnt = torch.where(valid.repeat_interleave(xors.shape[0]), cnt, 0)
    cum = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
    return cum, ends, cum[-1]


def expand_chunk(cum, total_pad: int):
    """Pair index of every hit slot in [0, total_pad): one count of
    pair starts plus a prefix sum (empty pairs collapse onto the next
    start, so the sum picks the containing pair)."""
    starts = cum[:-1]
    starts = starts[starts < total_pad]
    seg = torch.bincount(starts, minlength=total_pad)
    return torch.cumsum(seg, 0) - 1


# ---------------------------------------------------------------------------
# the x-drop scan: plain version of K2
# ---------------------------------------------------------------------------


def _xdrop_round(seq1p, seq2p, subflat, K, p1, p2, n, x_drop, step,
                 chunk, st):
    """One `chunk`-cell round for the lanes in `st`, resuming their
    carried sums (the continuation math of hitgen.py:145-179)."""
    base, cum, runmax, best, kbest, consumed = st
    dev = p1.device
    offs = torch.arange(chunk, dtype=_I64, device=dev)[None, :]
    at = (base[:, None] + offs) * step
    c1 = seq1p[(p1[:, None] + SEQ_PAD + at).clamp(0, seq1p.shape[0] - 1)]
    c2 = seq2p[(p2[:, None] + SEQ_PAD + at).clamp(0, seq2p.shape[0] - 1)]
    rem = n - base
    valid = offs < rem[:, None]
    sc = torch.where(valid, subflat[c1.to(_I64) * K + c2.to(_I64)], 0)
    c = (cum[:, None] + torch.cumsum(sc, 1)).to(_I32)
    m = torch.maximum(torch.cummax(c, 1).values, runmax[:, None])
    bad = (c < torch.clamp(m, min=0) - x_drop) & valid
    any_bad = bad.any(1)
    first_bad = torch.where(any_bad, bad.to(_I32).argmax(1), chunk)
    take = torch.clamp(torch.minimum(first_bad + 1, rem), max=chunk)
    take = torch.clamp(take, min=0)
    inpref = offs < take[:, None]
    cc = torch.where(inpref, c, MIN32)
    chunk_best, chunk_arg = cc.max(1)  # first index of the max
    better = chunk_best > best
    best = torch.where(better, chunk_best, best)
    kbest = torch.where(better, base + chunk_arg, kbest)
    consumed = base + take
    last = torch.clamp(take - 1, min=0)[:, None]
    cum = c.gather(1, last)[:, 0]
    runmax = m.gather(1, last)[:, 0]
    live = ~any_bad & (rem > chunk)
    return (base + chunk, cum, runmax, best, kbest, consumed), live


def xdrop_scan_plain(seq1p, seq2p, subflat, K: int, p1, p2, n,
                     x_drop: int, step: int):
    """Gap-free x-drop scan of every hit from (p1, p2) in direction
    `step` over at most n cells: returns (consumed, best, kbest) with
    kbest = -1 where best <= 0 (the final values of hitgen._xdrop_all).
    A scan stops at the first cell below max(runmax, 0) - x_drop,
    which counts in consumed; best moves only on a greater sum."""
    dev = p1.device
    H = p1.shape[0]
    p1 = p1.to(_I64)
    p2 = p2.to(_I64)
    n = n.to(_I64)
    subflat = subflat.to(_I32)
    consumed = torch.zeros(H, dtype=_I32, device=dev)
    best = torch.zeros(H, dtype=_I32, device=dev)
    kbest = torch.full((H,), -1, dtype=_I32, device=dev)
    for lo in range(0, H, XD_SLICE):
        sl = torch.arange(lo, min(lo + XD_SLICE, H), device=dev)
        sl = sl[n[sl] > 0]
        z = torch.zeros(sl.shape[0], dtype=_I64, device=dev)
        st = (z, z.to(_I32), z.to(_I32), z.to(_I32), z.to(_I32) - 1,
              z.to(_I32))
        chunk = XD_FIRST
        while sl.shape[0]:
            st, live = _xdrop_round(seq1p, seq2p, subflat, K, p1[sl],
                                    p2[sl], n[sl], x_drop, step, chunk, st)
            best[sl] = st[3]
            kbest[sl] = st[4].to(_I32)
            consumed[sl] = st[5].to(_I32)
            sl = sl[live]
            st = tuple(a[live] for a in st)
            chunk = XD_CHUNK
    kbest = torch.where(best > 0, kbest, -1)
    return consumed, best, kbest


# ---------------------------------------------------------------------------
# diagonal-hash chain resolution: plain versions of csrc/resolve_chains.cu
# ---------------------------------------------------------------------------

HASH_INACTIVE = -1


def chain_bounds(seg_start, live_s):
    """(starts, lens), each (DIAG_HASH_SIZE + 1,) int32: the first
    sorted index and the length of every chain of the hash-sorted hits,
    chains in sorted order, empty ones padded with start H and length
    0.  The dead hits sort into one sentinel chain after every hash;
    its length is 0 too (hitgen.py:366-376)."""
    dev = seg_start.device
    H = seg_start.shape[0]
    NCH = DIAG_HASH_SIZE + 1
    iota = torch.arange(H, dtype=_I64, device=dev)
    seg_id = torch.cumsum(seg_start.to(_I64), 0) - 1
    starts = torch.full((NCH,), H, dtype=_I64, device=dev).scatter_reduce(
        0, seg_id, iota, "amin")
    lens = torch.bincount(seg_id, minlength=NCH)
    lens = torch.where(live_s[torch.clamp(starts, max=H - 1)], lens, 0)
    return starts.to(_I32), lens.to(_I32)


def _walk_order(lens):
    """Chains by length, longest first, and how many still run at each
    step: a lockstep walk of step r touches a prefix of that order."""
    lens_s, by_len = torch.sort(lens.to(_I64), descending=True)
    nz = int((lens_s > 0).sum())
    lens_h = lens_s[:nz].cpu()
    max_len = int(lens_h[0]) if nz else 0
    running = torch.searchsorted(-lens_h, -torch.arange(
        min(max_len, RESOLVE_CHAIN_CAP + 1)), side="left").tolist()
    return by_len[:nz], running, max_len


def _resolve_chains(extent_s, pos2mL_s, de0_s, starts, lens, live_s):
    """The simple processor's drop protocol (process_for_simple_hit,
    seed_search.c:1056-1198) over hash-sorted hits, all chains in
    lockstep, one chain position per step (port of
    lastz_tpu/ops/hitgen.py::_resolve_chains_dev, :345-402).  de0_s is
    the chain's diagonal extent at its head, already activated (>= 0).
    A chain walks at most RESOLVE_CHAIN_CAP + 1 positions.  Returns
    (alive_s, de_before_s, converged); converged is False when a chain
    is longer than RESOLVE_CHAIN_CAP."""
    dev = extent_s.device
    H = extent_s.shape[0]
    ch, running, max_len = _walk_order(lens)
    st = starts[ch].to(_I64)
    cur = de0_s[st].to(_I64)
    alive = torch.ones(H, dtype=torch.bool, device=dev)
    de_before = torch.zeros(H, dtype=_I32, device=dev)
    for r, nr in enumerate(running):
        idx = st[:nr] + r
        c = cur[:nr]
        ok = c <= pos2mL_s[idx]
        de_before[idx] = c.to(_I32)
        alive[idx] = ok
        cur[:nr] = torch.where(ok & live_s[idx],
                               torch.maximum(c, extent_s[idx].to(_I64)), c)
    return alive, de_before, max_len <= RESOLVE_CHAIN_CAP


def _resolve_chains_recover(extent_s, start2_s, diag_s, de0_s, da0_s,
                            starts, lens, live_s):
    """Recover mode's drop protocol (process_for_recoverable_hit,
    seed_search.c:1221-1420; port of
    lastz_tpu/ops/hitgen.py::_resolve_chains_recover_dev, :408-468):
    a hit on a hashed diagonal that was extended past it is dropped
    only when the extension's true diagonal (da) is its own; a hit on
    another diagonal of the same hash is kept, with an unblocked left
    extension (de_before = 0).  de0_s/da0_s are the raw states at the
    chain's head (HASH_INACTIVE kept).  Returns (alive_s, de_before_s,
    fin_de, fin_da, converged); fin_de/fin_da are each chain's state
    after the launch, (DIAG_HASH_SIZE + 1,) in chain order."""
    dev = extent_s.device
    H = extent_s.shape[0]
    # an empty chain's state is read at the last hit, as the loop reads it
    head = torch.clamp(starts.to(_I64), max=H - 1)
    fin_de = de0_s[head].to(_I32)
    fin_da = da0_s[head].to(_I32)
    ch, running, max_len = _walk_order(lens)
    st = starts[ch].to(_I64)
    cur = fin_de[ch].to(_I64)
    curd = fin_da[ch].to(_I64)
    alive = torch.ones(H, dtype=torch.bool, device=dev)
    de_before = torch.zeros(H, dtype=_I32, device=dev)
    for r, nr in enumerate(running):
        idx = st[:nr] + r
        c, d = cur[:nr], curd[:nr]
        t = start2_s[idx]
        e = extent_s[idx].to(_I64)
        dg = diag_s[idx].to(_I64)
        lv = live_s[idx]
        inactive = c == HASH_INACTIVE
        c0 = torch.where(inactive, 0, c)
        d0 = torch.where(inactive, dg, d)
        covered = (c0 > t) & ~inactive
        unb = covered & (d0 != dg)
        ok = ~(covered & (d0 == dg))
        de_before[idx] = torch.where(unb, 0, c0).to(_I32)
        alive[idx] = ok
        upd = ok & (e > c0)
        cur[:nr] = torch.where(lv, torch.where(upd, e, c0), c)
        curd[:nr] = torch.where(lv, torch.where(upd, dg, d0), d)
    fin_de[ch] = cur.to(_I32)
    fin_da[ch] = curd.to(_I32)
    return alive, de_before, fin_de, fin_da, max_len <= RESOLVE_CHAIN_CAP


# ---------------------------------------------------------------------------
# one fixed-budget hit launch
# ---------------------------------------------------------------------------


def hit_launch(seq1p, seq2p, subflat, csr_pos, alive_tab, cum, ends,
               karr, de, da, hit_base: int, total: int, chunk_lo: int,
               adj_start: int, step: int, seed_len: int, thresh: int,
               band: int, len1: int, len2: int, csr_resolve=None,
               q_resolve=None, budgets=None, *, x_drop: int,
               no_extend: bool, self_compare: bool, same_strand: bool,
               use_thresh: bool, has_alive: bool, K: int, nprobe: int,
               recover: bool = False, has_resolve: bool = False,
               H: int = HIT_BUDGET, out_cap: int = OUT_CAP):
    """One budgeted slice [hit_base, hit_base+H) of a chunk's candidate
    hits (hitgen.py:482-654).  karr is the slice's pair index per hit
    (expand_chunk).  `da` is the diagActual state, read and advanced
    only with `recover` (--recoverseeds).  With `has_resolve`
    (overweight seeds) a hit also needs its resolving bits: csr_resolve
    (int32 per index entry, its bits unsigned) against q_resolve (int64
    per query window) within budgets[probe] mismatches.  Returns (de',
    da', out (9, out_cap) int32, scalars (6,) int64); de' and da' are
    new tensors, or de and da themselves when the launch is discarded.

    out rows: pos1, pos2, qidx (absolute query window index), lscore,
    lstart, rscore, rstop, de_before, bind.
    scalars: n_keep, n_live, n_dropped, n_alive, converged, 0.
    """
    from .resolve_cuda import resolve_chains
    from .xdrop_cuda import xdrop_scan

    dev = karr.device
    i = torch.arange(H, dtype=_I64, device=dev)
    abs_i = hit_base + i
    live = abs_i < total

    k = torch.clamp(karr, 0, ends.shape[0] - 1)
    within = abs_i - cum[k]
    pidx = torch.div(k, nprobe, rounding_mode="floor")
    csr_idx = torch.clamp(ends[k] - 1 - within, 0, csr_pos.shape[0] - 1)
    pos1 = adj_start + step * csr_pos[csr_idx].to(_I64)
    pos2 = chunk_lo + seed_len + pidx
    if has_resolve:
        # overweight seeds: the demoted (resolving) bits of the query
        # window against the entry's, within the probe's leftover
        # transition budget (seed_search.c:878-980); a 32-bit SWAR
        # popcount on int64, the top byte masked where uint32 wraps
        x = ((csr_resolve[csr_idx].to(_I64) & 0xFFFFFFFF)
             ^ q_resolve[torch.clamp(pidx, 0, q_resolve.shape[0] - 1)])
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        mism = ((((x + (x >> 4)) & 0x0F0F0F0F) * 0x01010101) >> 24) & 0xFF
        live &= mism <= budgets[k % nprobe]
    if has_alive:
        live &= alive_tab[csr_idx] != 0
    if self_compare:
        if same_strand:
            live &= pos1 < pos2
        else:
            live &= (pos1 - seed_len) < (len2 - 1) - (pos2 - seed_len)
    if same_strand:
        live &= (pos2 - pos1) <= band
    diag = pos1 - pos2
    h = diag & (DIAG_HASH_SIZE - 1)

    zero = torch.zeros(H, dtype=_I64, device=dev)
    if no_extend:
        extent = pos2
        lscore = rscore = lc = zero
        lstart = rstop = pos1
    else:
        n_l = torch.where(live, pos1 - torch.clamp(diag, min=0), 0)
        stop1r = torch.clamp(len2 + diag, max=len1)
        n_r = torch.where(live, torch.clamp(stop1r - pos1, min=0), 0)
        (lc, lb, lk), (rc, rb, rk) = xdrop_scan(
            seq1p, seq2p, subflat, K, pos1, pos2, n_l, n_r, x_drop)
        lc, lb, lk, rc, rb, rk = (a.to(_I64) for a in
                                  (lc, lb, lk, rc, rb, rk))
        lscore = torch.clamp(lb, min=0)
        lstart = torch.where(lb > 0, pos1 - 1 - lk, pos1)
        rscore = torch.clamp(rb, min=0)
        rstop = torch.where(rb > 0, pos1 + rk + 1, pos1)
        extent = pos1 + rc - diag

    # hash-chain resolution over the whole launch
    key = torch.where(live, h, DIAG_HASH_SIZE)  # dead hits: own chain
    key_s, order = torch.sort(key, stable=True)
    seg_start = torch.cat([key_s.new_ones(1, dtype=torch.bool),
                           key_s[1:] != key_s[:-1]])
    live_s = live[order]
    starts, lens = chain_bounds(seg_start, live_s)
    key_c = torch.clamp(key_s, max=DIAG_HASH_SIZE - 1)
    if recover:
        alive_s, de_before_s, fin_de, fin_da, converged = resolve_chains(
            starts, lens, extent[order], (pos2 - seed_len)[order],
            de[key_c], live_s, diag_s=diag[order], da0_s=da[key_c])
        # each chain's end state back at its hash (hitgen.py:596-602)
        valid = lens > 0
        at = key_s[starts[valid].to(_I64)]
        de_adv = de.clone()
        da_adv = da.clone()
        de_adv[at] = fin_de[valid]
        da_adv[at] = fin_da[valid]
    else:
        # HASH_INACTIVE (-1) activates to 0
        alive_s, de_before_s, converged = resolve_chains(
            starts, lens, extent[order], (pos2 - seed_len)[order],
            torch.clamp(de[key_c], min=0), live_s)
    inv = torch.empty_like(order)
    inv[order] = i
    alive = alive_s[inv] & live
    de_before = de_before_s[inv].to(_I64)
    if not recover:
        # advance the diagonal-extent state; kept only when the launch
        # is not discarded (overflow or unconverged), below
        de_adv = de.scatter_reduce(
            0, torch.where(live, h, 0),
            torch.where(alive, extent, -1).to(de.dtype), "amax")
        da_adv = da

    if no_extend:
        cand = alive
        bind = torch.zeros(H, dtype=torch.bool, device=dev)
    else:
        stop1_blk = torch.clamp(de_before + diag, min=0)
        bind = alive & (lc > pos1 - stop1_blk)
        cand = alive & (bind | (lscore + rscore >= thresh)) \
            if use_thresh else alive

    # in-order compaction
    sel = torch.nonzero(cand)[:, 0]
    n_keep = sel.shape[0]
    keep = sel[:out_cap]
    out = torch.zeros((9, out_cap), dtype=_I32, device=dev)
    rows = (pos1, pos2, pidx + chunk_lo, lscore, lstart, rscore, rstop,
            de_before, bind.to(_I64))
    out[:, : keep.shape[0]] = torch.stack([v[keep] for v in rows]).to(_I32)
    discard = n_keep > out_cap or not converged
    n_live = int(live.sum())
    n_alive = int(alive.sum())
    scalars = torch.tensor([n_keep, n_live, n_live - n_alive, n_alive,
                            int(converged), 0])
    if discard:
        return de, da, out, scalars
    return de_adv, da_adv, out, scalars
