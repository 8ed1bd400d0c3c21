"""The seed stage in plain PyTorch: spaced-seed hits and gap-free x-drop
extension to HSPs, as LASTZ defines them. It runs on any torch device
(the card in the benchmark, once the window has closed; the CPU in the
tests).

- A word is the `pattern`'s care positions of a window whose every base
  is an uppercase A, C, G or T (lowercase is soft-masked and never
  seeds). A hit pairs equal target and query words; with transitions,
  also words that differ by one transition (A<->G, C<->T) at one care
  position.
- Hits on one diagonal are taken in query order. A hit whose window
  starts before the diagonal's extent (where the last extension's
  right scan stopped) is dropped; otherwise it is extended: left from
  its window's end down to the extent, then right, each scan ending at
  the first cell whose running score falls `x_drop` below its best
  (and below zero), and keeping its best prefix. LASTZ hashes
  diagonals into 65,536 slots that share one extent; this reference
  keeps one extent a diagonal, so where two diagonals collide LASTZ may
  drop or shorten an HSP that is found here.
- A marginal HSP (score from K to 3K) is scaled by the entropy of its
  matched bases; HSPs scoring at least K are kept.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ASCII -> 0..3 for uppercase ACGT only
UPPER = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    UPPER[_c] = _i

# the scans advance in chunks of cells: a short first one, since most
# random hits die within a few dozen cells, then longer ones
CHUNKS = (48, 128)
PAD = 128
I64 = torch.int64


def words(seq: np.ndarray, pattern: str):
    """(end positions, 2-bit packed care words) of the valid windows;
    a window ending at e (exclusive) covers seq[e - len : e]."""
    L = len(pattern)
    n = len(seq)
    if n < L:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    code = UPPER[seq]
    bad = np.concatenate(([0], np.cumsum(code == 255)))
    ends = np.arange(L, n + 1)
    ends = ends[(bad[ends] - bad[ends - L]) == 0]
    w = np.zeros(len(ends), dtype=np.int64)
    for p, ch in enumerate(pattern):
        if ch == "1":
            w = (w << 2) | code[ends - L + p].astype(np.int64)
    return ends, w


class TargetIndex:
    """The target's words, sorted once, on `device`."""

    def __init__(self, target: np.ndarray, pattern: str, device="cpu"):
        ends, w = words(target, pattern)
        key = torch.from_numpy((w << 32) | ends).to(device)
        key = torch.sort(key).values
        self.words = key >> 32
        self.ends = key & 0xFFFFFFFF
        self.pattern = pattern
        self.device = torch.device(device)


def seed_hits(index: TargetIndex, query: np.ndarray, transitions: bool):
    """All hits (target end, query end) of the query on the index, as
    int64 tensors on the index's device."""
    dev = index.device
    q_ends, q_words = (torch.from_numpy(a).to(dev)
                       for a in words(query, index.pattern))
    cares = index.pattern.count("1")
    flips = [0] + ([2 << (2 * k) for k in range(cares)] if transitions
                   else [])
    t_all, q_all = [], []
    for flip in flips:
        pw = q_words ^ flip
        lo = torch.searchsorted(index.words, pw, right=False)
        hi = torch.searchsorted(index.words, pw, right=True)
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            continue
        q_rep = torch.repeat_interleave(q_ends, cnt)
        start = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt)
        t_all.append(index.ends[start + torch.arange(total, device=dev)])
        q_all.append(q_rep)
    if not t_all:
        z = torch.zeros(0, dtype=I64, device=dev)
        return z, z
    return torch.cat(t_all), torch.cat(q_all)


def padded(seq: np.ndarray, device="cpu") -> torch.Tensor:
    """The sequence with PAD bytes of 0 on both sides, for the scans."""
    z = np.zeros(PAD, np.uint8)
    return torch.from_numpy(np.concatenate([z, seq, z])).to(device)


def xdrop_scan(s1p, s2p, flat, i0, j0, step, limit, x_drop):
    """Gap-free scans in lockstep over PAD-padded sequences: scan h
    reads s1[i0 + k*step] against s2[j0 + k*step] for k < limit[h], with
    the scores of the flat 256 x 256 table. Returns (consumed, best,
    kbest): the cells before the first whose running score c falls
    below max(max prefix, 0) - x_drop; the best running score among
    them (0 when none is positive) and the index of its first
    occurrence."""
    dev = s1p.device
    H = len(i0)
    consumed = torch.zeros(H, dtype=I64, device=dev)
    best = torch.zeros(H, dtype=I64, device=dev)
    kbest = torch.full((H,), -1, dtype=I64, device=dev)
    run = torch.zeros(H, dtype=I64, device=dev)
    top = torch.zeros(H, dtype=I64, device=dev)
    live = torch.arange(H, device=dev)
    low = torch.iinfo(torch.int64).min
    k0 = 0
    n = 0
    while len(live):
        width = CHUNKS[min(n, len(CHUNKS) - 1)]
        n += 1
        ks = k0 + torch.arange(width, device=dev)
        inside = ks[None, :] < limit[live, None]
        # a live scan has read every cell before k0 inside its limit, so
        # a chunk reads at most its width past the limit: inside the pad
        ii = i0[live, None] + PAD + step * ks[None, :]
        jj = j0[live, None] + PAD + step * ks[None, :]
        sc = flat[s1p[ii].to(I64) * 256 + s2p[jj].to(I64)]
        sc = torch.where(inside, sc, torch.zeros_like(sc))
        c = run[live, None] + torch.cumsum(sc, dim=1)
        m = torch.maximum(torch.cummax(c, dim=1).values, top[live, None])
        fail = (c < torch.clamp(m, min=0) - x_drop) | ~inside
        any_fail = fail.any(dim=1)
        first = torch.where(any_fail, fail.to(torch.int32).argmax(dim=1),
                            torch.full_like(any_fail, width, dtype=I64))
        ok = torch.arange(width, device=dev)[None, :] < first[:, None]
        cm = torch.where(ok, c, torch.full_like(c, low))
        cbest, carg = cm.max(dim=1)
        better = ok.any(dim=1) & (cbest > best[live])
        kbest[live[better]] = k0 + carg[better]
        best[live[better]] = cbest[better]
        consumed[live] = k0 + first
        run[live] = c[:, -1]
        top[live] = m[:, -1]
        live = live[~any_fail]
        k0 += width
    return consumed, best, kbest


def entropy(s: np.ndarray, t: np.ndarray) -> float:
    """LASTZ's entropy of a gap-free alignment: over positions where the
    two bases are the same uppercase A, C, G or T; 1 under 20 of them."""
    eq = s == t
    counts = [int(np.count_nonzero(eq & (s == c))) for c in b"ACGT"]
    if sum(counts) < 20:
        return 1.0
    acc = 0.0
    for c in counts:
        if c:
            p = c / len(s)
            acc += p * math.log(p)
    return -acc / math.log(4.0)


def hsps(index: TargetIndex, target, query, sub, transitions: bool,
         x_drop: int, k_thresh: int, entropic: bool = True, t_pad=None):
    """The HSPs of one query strand: an (n, 4) int64 array of (target
    start, query start, length, score), origin 0. `t_pad` is the padded
    target on the index's device, when the caller keeps one."""
    dev = index.device
    t_end, q_end = seed_hits(index, query, transitions)
    L = len(index.pattern)
    if len(t_end) == 0:
        return np.zeros((0, 4), np.int64)
    diag = t_end - q_end
    n1, n2 = len(target), len(query)
    span = n2 + 2
    # hits by diagonal, then query position, under one increasing key
    key, order = torch.sort((diag + n2) * span + (q_end - L))
    t_end, q_end, diag = t_end[order], q_end[order], diag[order]
    first = torch.ones(len(diag), dtype=torch.bool, device=dev)
    first[1:] = diag[1:] != diag[:-1]
    g_lo = torch.nonzero(first).flatten()
    g_hi = torch.cat([g_lo[1:], torch.tensor([len(diag)], device=dev)])
    g_diag = diag[g_lo]
    extent = torch.zeros(len(g_lo), dtype=I64, device=dev)
    ptr = g_lo.clone()
    if t_pad is None:
        t_pad = padded(target, dev)
    q_pad = padded(query, dev)
    flat = torch.from_numpy(sub.astype(np.int64).reshape(-1)).to(dev)
    found = []
    active = torch.arange(len(g_lo), device=dev)
    while len(active):
        d = g_diag[active]
        want = (d + n2) * span + torch.clamp(extent[active], max=span - 1)
        p = torch.maximum(ptr[active], torch.searchsorted(key, want))
        keep = p < g_hi[active]
        active, p, d = active[keep], p[keep], d[keep]
        if not len(active):
            break
        pos1 = t_end[p]
        pos2 = q_end[p]
        stop1 = torch.clamp(extent[active] + d, min=0)
        lc, lb, lk = xdrop_scan(t_pad, q_pad, flat, pos1 - 1, pos2 - 1, -1,
                                pos1 - stop1, x_drop)
        stop1r = torch.clamp(n2 + d, max=n1)
        rc, rb, rk = xdrop_scan(t_pad, q_pad, flat, pos1, pos2, 1,
                                torch.clamp(stop1r - pos1, min=0), x_drop)
        left_start = torch.where(lb > 0, pos1 - 1 - lk, pos1)
        right_stop = torch.where(rb > 0, pos1 + rk + 1, pos1)
        sim = lb + rb
        extent[active] = torch.maximum(extent[active], pos1 + rc - d)
        ptr[active] = p + 1
        big = sim >= k_thresh
        if big.any():
            found.append(torch.stack([left_start[big], right_stop[big],
                                      d[big], sim[big]], 1).cpu().numpy())
    out = []
    for a, b, d, s in (np.concatenate(found) if found else []):
        if entropic and k_thresh <= s <= 3 * k_thresh:
            s = int(s * entropy(target[a:b], query[a - d:b - d]))
        if s >= k_thresh:
            out.append((a, a - d, b - a, s))
    if not out:
        return np.zeros((0, 4), np.int64)
    return np.array(sorted(out), dtype=np.int64)
