"""Seed-word position index over the target sequence.

The reference builds `last[word] -> most recent position` plus a
`prev[pos]` linked list (pos_table.c:118-470, 1326-1397), which yields,
for each word, its target end-positions in DESCENDING order.  That
enumeration order is observable in output (it sets HSP discovery
order), so it is part of this module's contract.

Here the index is a CSR over sorted packed words, built with O(n log n)
vectorized numpy (and, on a device, torch.sort and a scatter-add):
positions are stored ascending per word, and `positions_for(word)`
returns them reversed, which is exactly the reference's last/prev walk.

Position values are word END positions (one past the last base,
origin-0 byte index + 1), stored divided by `step` relative to
adj_start = start - (start % step), mirroring pos_table.c:1018-1122.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..core.seeds import Seed


@dataclass
class PositionTable:
    seed: Seed
    step: int
    start: int  # first sequence position considered (origin-0)
    end: int  # one past the last position considered
    adj_start: int
    # CSR: for word w, stored positions are csr_pos[csr_start[w]:csr_start[w+1]]
    # ascending; actual end-position = adj_start + step*value.
    csr_start: np.ndarray  # (4^weight + 1,) int64
    csr_pos: np.ndarray  # (num_entries,) uint32/int64
    # packed resolving bits per entry (aligned with csr_pos), for
    # overweight seeds (replaces the reference's 'asBits' target copy
    # with a precomputed per-entry word); None unless seed.type == 'R'
    csr_resolve: np.ndarray | None = None
    # liveness mask per entry; None means all alive (dynamic masking
    # kills entries instead of restructuring the CSR)
    alive: np.ndarray | None = None

    @property
    def num_words(self) -> int:
        return len(self.csr_start) - 1

    def positions_for(self, word: int) -> np.ndarray:
        """Target end positions for `word`, in reference (descending) order."""
        lo, hi = self.csr_start[word], self.csr_start[word + 1]
        stored = self.csr_pos[lo:hi]
        if self.alive is not None:
            stored = stored[self.alive[lo:hi]]
        return self.adj_start + self.step * stored[::-1].astype(np.int64)

    def counts(self) -> np.ndarray:
        return np.diff(self.csr_start)

    def remove_positions(self, word_end_positions: np.ndarray, words: np.ndarray):
        """Remove specific (word, end position) entries (dynamic masking).

        Marks entries as removed by setting them to a sentinel that
        positions_for filters out.  Rebuild is cheap, so we just rebuild
        the CSR without the removed entries.
        """
        stored = ((word_end_positions - self.adj_start) // self.step).astype(self.csr_pos.dtype)
        # build removal mask per (word, stored) pair
        kill = {}
        for w, p in zip(words.tolist(), stored.tolist()):
            kill.setdefault(w, set()).add(p)
        keep = np.ones(len(self.csr_pos), dtype=bool)
        for w, kset in kill.items():
            lo, hi = self.csr_start[w], self.csr_start[w + 1]
            seg = self.csr_pos[lo:hi]
            mask = np.isin(seg, np.fromiter(kset, dtype=seg.dtype))
            keep[lo:hi] = ~mask
        new_pos = self.csr_pos[keep]
        counts = np.zeros(self.num_words, dtype=np.int64)
        # recompute counts by word
        word_of_entry = np.repeat(
            np.arange(self.num_words), np.diff(self.csr_start))
        new_words = word_of_entry[keep]
        np.add.at(counts, new_words, 1)
        self.csr_start = np.concatenate([[0], np.cumsum(counts)])
        self.csr_pos = new_pos
        self._native_csr = None  # invalidate the native-sweep cache


def _window_words(codes: np.ndarray, length: int, bits_per: int) -> tuple[np.ndarray, np.ndarray]:
    """All sliding windows as packed integers + validity mask.

    codes: int8 per-base 2-bit codes (-1 = invalid).
    Returns (words uint64 indexed by end position offset, valid bool);
    words[i] covers codes[i-length+1 .. i]... indexed so that entry k
    corresponds to the window ENDING at base index (length-1+k).
    """
    n = len(codes)
    if n < length:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    num = n - length + 1
    w = np.zeros(num, dtype=np.uint64)
    valid = np.ones(num, dtype=bool)
    c64 = codes.astype(np.int64)
    for i in range(length):
        seg = c64[i : i + num]
        valid &= seg >= 0
        if bits_per == 2:
            w = (w << np.uint64(2)) | (np.maximum(seg, 0).astype(np.uint64))
        else:
            w = (w << np.uint64(1)) | (np.maximum(seg, 0).astype(np.uint64) & np.uint64(1))
    return w, valid


def build_seed_position_table(
    seq_v: np.ndarray,
    start: int,
    end: int,
    char_to_bits: np.ndarray,
    seed: Seed,
    step: int = 1,
    scratch: dict | None = None,
) -> PositionTable:
    """Vectorized equivalent of reference build_seed_position_table.

    seq_v: uint8 ASCII target.  Words whose window includes any invalid
    character are skipped; a word ending at END position p (origin-0,
    exclusive) is stored iff p % step == 0.

    scratch: optional dict reused across calls on the native path (the
    tweener builds a table per 2 kb window); the returned table ALIASES
    the scratch buffers and is invalidated by the next build that
    passes the same dict.
    """
    if step < 1:
        raise ValueError("step must be >= 1")
    if end == 0:
        end = len(seq_v)
    if end <= start:
        raise ValueError("interval is void")
    adj_start = start - (start % step)

    # whole-build native fast path (counting sort straight into the
    # CSR; native/ydrop_row.cpp build_postable) — the numpy chain
    # below is the oracle and covers overweight/rev-comp seeds
    if seed.type != "R" and not seed.rev_comp \
            and (end - start) < (1 << 31) and seed.weight <= 26:
        from ..native import get_lib
        lib = get_lib()
        if lib is not None and hasattr(lib, "build_postable"):
            import ctypes
            num_words = 1 << seed.weight
            cap = max((end - start - seed.length) // step + 2, 1)
            if scratch is not None:
                csr_start = scratch.get("csr_start")
                if csr_start is None or len(csr_start) != num_words + 1:
                    csr_start = scratch["csr_start"] = \
                        np.empty(num_words + 1, np.int32)
                out_pos = scratch.get("out_pos")
                if out_pos is None or len(out_pos) < cap:
                    out_pos = scratch["out_pos"] = \
                        np.empty(cap, np.uint32)
            else:
                # np.empty is safe: native build_postable zero-fills
                # csr_start itself in its pass 0 (ydrop_row.cpp memset)
                csr_start = np.empty(num_words + 1, np.int32)
                out_pos = np.empty(cap, np.uint32)
            sv = np.ascontiguousarray(seq_v, np.uint8)
            # per-seed cache (the tweener builds a table per window)
            cached = getattr(seed, "_pt_tables", None)
            if cached is None or cached[3] is not char_to_bits:
                c2b = np.ascontiguousarray(char_to_bits, np.int8)
                bmx = np.asarray(seed.bit_map,
                                 np.int64).reshape(-1, 2)
                bm_src = np.ascontiguousarray(bmx[:, 0])
                bm_dst = np.ascontiguousarray(bmx[:, 1])
                cached = (c2b, bm_src, bm_dst, char_to_bits)
                seed._pt_tables = cached
            c2b, bm_src, bm_dst, _ = cached
            bm = bm_src  # len() only
            i64c = ctypes.c_int64
            n = lib.build_postable(
                sv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                i64c(start), i64c(end),
                c2b.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                i64c(seed.length), i64c(seed.bits_per_base),
                bm_src.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)),
                bm_dst.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)),
                i64c(len(bm)), i64c(step), i64c(adj_start),
                i64c(num_words),
                csr_start.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)),
                out_pos.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)))
            if n >= 0:
                assert n <= cap
                return PositionTable(
                    seed=seed, step=step, start=start, end=end,
                    adj_start=adj_start, csr_start=csr_start,
                    csr_pos=np.ascontiguousarray(out_pos[:n]))

    codes = char_to_bits[seq_v[start:end]]
    L = seed.length
    words, valid = _window_words(codes, L, seed.bits_per_base)
    # end position (origin-0 exclusive) of window k is start + L + k
    end_pos = start + L + np.arange(len(words), dtype=np.int64)
    on_step = (end_pos % step) == 0
    sel = valid & on_step
    words = words[sel]
    end_pos = end_pos[sel]

    packed = seed.pack(words)
    stored = ((end_pos - adj_start) // step).astype(np.uint32)

    num_words = 1 << seed.weight
    order = np.argsort(packed, kind="stable")  # stable keeps ascending pos
    sorted_words = packed[order]
    sorted_pos = stored[order]
    # csr_start[w] = first CSR slot of word w, via a single searchsorted
    # over the sorted words (no 4^W-sized bincount/cumsum temporaries;
    # int32 slots unless the table is impossibly large)
    dt = np.int32 if len(sorted_pos) < (1 << 31) else np.int64
    csr_start = np.empty(num_words + 1, dtype=dt)
    _filled = False
    if dt is np.int32:
        from ..native import get_lib
        lib = get_lib()
        if lib is not None and hasattr(lib, "csr_fill"):
            import ctypes
            sw = np.ascontiguousarray(sorted_words, dtype=np.uint32)
            lib.csr_fill(
                sw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.c_int64(len(sw)), ctypes.c_int64(num_words),
                csr_start.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)))
            _filled = True
    if not _filled:
        csr_start[:num_words] = np.searchsorted(
            sorted_words, np.arange(num_words, dtype=np.uint32))
        csr_start[num_words] = len(sorted_pos)

    csr_resolve = None
    if seed.type == "R":
        csr_resolve = seed.pack_resolve(words)[order]

    return PositionTable(
        seed=seed,
        step=step,
        start=start,
        end=end,
        adj_start=adj_start,
        csr_start=csr_start,
        csr_pos=sorted_pos,
        csr_resolve=csr_resolve,
    )


class DevicePositionTable(PositionTable):
    """Position table whose CSR is torch tensors on a device, built there
    (port of lastz_tpu/index/postable.py:262-307).  The device search
    reads dev_csr_start and dev_csr_pos in place; the host arrays
    csr_start and csr_pos are fetched only when a host tier asks for
    them, and `host_fetches` counts those fetches over every table.

    dev_csr_pos is longer than n_entries: its tail holds the positions
    of the windows that were not indexed (sorted behind every word).
    `host_start`/`host_pos`, where given, are host copies that are
    already at hand (a capsule's arrays); they are served without a
    fetch and do not count as a change of the table."""

    host_fetches = 0

    def __init__(self, seed, step, start, end, adj_start, dev_csr_start,
                 dev_csr_pos, n_entries, csr_resolve=None, host_start=None,
                 host_pos=None):
        self.seed = seed
        self.step = step
        self.start = start
        self.end = end
        self.adj_start = adj_start
        self.dev_csr_start = dev_csr_start
        self.dev_csr_pos = dev_csr_pos
        self.n_entries = int(n_entries)
        self.csr_resolve = csr_resolve
        self.alive = None
        self._host_start = host_start
        self._host_pos = host_pos
        self._assigned = False
        self._copies = {}  # device -> (csr_start, csr_pos), see on()
        self._copy_lock = threading.Lock()

    def on(self, device):
        """(csr_start, csr_pos) on `device`: the table's own tensors on
        the device it was built on, else one copy a device, made at the
        first call.  The copying stream is synchronized once, so every
        stream of that device may read the copy."""
        import torch

        from ..device import resolve_device
        device = resolve_device(device)
        if device == self.dev_csr_start.device:
            return self.dev_csr_start, self.dev_csr_pos
        with self._copy_lock:
            hit = self._copies.get(device)
            if hit is None:
                hit = (self.dev_csr_start.to(device),
                       self.dev_csr_pos.to(device))
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
                self._copies[device] = hit
        return hit

    @property
    def in_place(self) -> bool:
        """True while the device tensors are the table: no entry killed
        (alive) and no host array assigned since the build."""
        return self.alive is None and not self._assigned

    @property
    def num_words(self) -> int:
        return self.dev_csr_start.shape[0] - 1

    @property
    def csr_start(self):
        if self._host_start is None:
            DevicePositionTable.host_fetches += 1
            self._host_start = self.dev_csr_start.cpu().numpy()
        return self._host_start

    @csr_start.setter
    def csr_start(self, v):
        self._host_start = v
        self._assigned = True

    @property
    def csr_pos(self):
        if self._host_pos is None:
            DevicePositionTable.host_fetches += 1
            self._host_pos = self.dev_csr_pos[: self.n_entries].cpu().numpy()
        return self._host_pos

    @csr_pos.setter
    def csr_pos(self, v):
        self._host_pos = v
        self._assigned = True


def build_seed_position_table_device(
    seq_v: np.ndarray,
    start: int,
    end: int,
    char_to_bits: np.ndarray,
    seed: Seed,
    step: int = 1,
    *,
    device,
) -> DevicePositionTable:
    """build_seed_position_table on `device` (port of
    lastz_tpu/index/postable.py:310-336): the target's codes go up as
    int8, and word packing, selection, the stable sort and the CSR
    counts run there.  Entries of a word stay in ascending position
    order, as in the host build."""
    import torch

    from ..ops.hitgen import pack_query_words

    if step < 1:
        raise ValueError("step must be >= 1")
    if end == 0:
        end = len(seq_v)
    if end <= start:
        raise ValueError("interval is void")
    adj_start = start - (start % step)
    nw = 1 << seed.weight
    codes = torch.from_numpy(
        char_to_bits[seq_v[start:end]].astype(np.int8)).to(device)
    if codes.shape[0] < seed.length:
        csr_start = torch.zeros(nw + 1, dtype=torch.int32, device=device)
        csr_pos = torch.zeros(0, dtype=torch.int32, device=device)
        n = 0
    else:
        packed, valid = pack_query_words(codes, seed.bit_map, seed.length,
                                         seed.bits_per_base)
        csr_start, csr_pos, n = build_csr(
            packed, valid, nw=nw, step=step, length=seed.length,
            start=start, adj=adj_start)
    return DevicePositionTable(
        seed=seed, step=step, start=start, end=end, adj_start=adj_start,
        dev_csr_start=csr_start, dev_csr_pos=csr_pos, n_entries=n)


def build_csr(packed, valid, *, nw: int, step: int, length: int,
              start: int, adj: int):
    """The CSR of the windows' packed words (port of _build_csr_impl,
    lastz_tpu/index/postable.py:367-385): the windows not indexed get
    the key nw, so they sort behind every word, and a stable sort keeps
    each word's positions ascending.  Returns (csr_start (nw+1,) int32,
    csr_pos (num,) int32, n_entries)."""
    import torch
    dev = packed.device
    num = packed.shape[0]
    big = start + length + num >= (1 << 31)
    end_pos = start + length + torch.arange(
        num, dtype=torch.int64 if big else torch.int32, device=dev)
    sel = valid
    if step != 1:
        sel = sel & (end_pos % step == 0)
    stored = torch.div(end_pos - adj, step,
                       rounding_mode="floor").to(torch.int32)
    key = torch.where(sel, packed, nw).to(torch.int32)
    _, order = torch.sort(key, stable=True)
    csr_pos = stored[order]
    cnt = torch.zeros(nw, dtype=torch.int32, device=dev).scatter_add_(
        0, torch.clamp(key, max=nw - 1).to(torch.int64),
        sel.to(torch.int32))
    csr_start = torch.cat([cnt.new_zeros(1),
                           torch.cumsum(cnt, 0, dtype=torch.int32)])
    return csr_start, csr_pos, int(sel.sum())


def build_quantum_seed_position_table(
    seq_v: np.ndarray,
    start: int,
    end: int,
    scoring,
    seed: Seed,
    step: int = 1,
) -> PositionTable:
    """Position table over a quantum target (reference
    build_quantum_seed_position_table, pos_table.c:235-283): each quantum
    character maps to its closest bottleneck 2-bit code via qToBest; ties
    rotate by absolute position (record_seed_positions_quantum,
    pos_table.c:93 — index is one past the char, `(s - seq->v)`)."""
    if step < 1:
        raise ValueError("step must be >= 1")
    if end == 0:
        end = len(seq_v)
    if end <= start:
        raise ValueError("interval is void")
    if seed.type != "S":
        raise SystemExit(
            "(internal error in build_quantum_seed_position_table:"
            " strict seeds only)")
    q_to_best = scoring.q_to_best or {}
    adj_start = start - (start % step)

    codes = np.full(end - start, -1, dtype=np.int64)
    window = seq_v[start:end]
    for ch, bits in q_to_best.items():
        if not bits:
            continue
        idx = np.flatnonzero(window == ch)
        if len(bits) == 1:
            codes[idx] = bits[0]
        else:
            # absolute position of the char + 1, modulo the tie count
            codes[idx] = np.asarray(bits, dtype=np.int64)[
                (idx + start + 1) % len(bits)]

    L = seed.length
    words, valid = _window_words(codes, L, 2)
    end_pos = start + L + np.arange(len(words), dtype=np.int64)
    on_step = (end_pos % step) == 0
    sel = valid & on_step
    words = words[sel]
    end_pos = end_pos[sel]

    packed = seed.pack(words)
    stored = ((end_pos - adj_start) // step).astype(np.uint32)

    num_words = 1 << seed.weight
    order = np.argsort(packed, kind="stable")
    counts = np.bincount(packed[order], minlength=num_words)
    csr_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    return PositionTable(
        seed=seed,
        step=step,
        start=start,
        end=end,
        adj_start=adj_start,
        csr_start=csr_start,
        csr_pos=stored[order],
        csr_resolve=None,
    )


def limit_position_table(pt: PositionTable, max_count: int, keep_fraction: float = 0.0):
    """Drop words occurring more than max_count times (reference
    limit_position_table / --maxwordcount, pos_table.c:1763-2052).

    With keep_fraction set, max_count is chosen adaptively so that at
    least `keep_fraction` of word instances are kept.
    """
    counts = pt.counts()
    if keep_fraction > 0:
        total = counts.sum()
        if total == 0:
            return 0
        # choose the smallest count c such that sum(counts[counts<=c]) /
        # total >= keep_fraction
        order = np.sort(counts[counts > 0])
        csum = np.cumsum(order)
        idx = np.searchsorted(csum, keep_fraction * total)
        idx = min(idx, len(order) - 1)
        max_count = int(order[idx])
    if max_count <= 0:
        return 0
    over = np.nonzero(counts > max_count)[0]
    if len(over) == 0:
        return 0
    keep = np.ones(len(pt.csr_pos), dtype=bool)
    for w in over:
        keep[pt.csr_start[w] : pt.csr_start[w + 1]] = False
    word_of_entry = np.repeat(np.arange(pt.num_words), counts)
    new_words = word_of_entry[keep]
    pt.csr_pos = pt.csr_pos[keep]
    new_counts = np.bincount(new_words, minlength=pt.num_words)
    pt.csr_start = np.concatenate([[0], np.cumsum(new_counts)]).astype(np.int64)
    return len(over)


def dump_position_table(out, pt: PositionTable, seed,
                        show_positions: bool, show_counts: bool):
    """reference dump_position_table (pos_table.c:1504): one line per
    occupied word, '%0*X/<seedstring>:' then counts and/or positions
    (positions most-recent first, comma separated)."""
    from ..core.seeds import packed_to_string

    hex_width = (seed.weight + 3) // 4
    occupied = np.nonzero(np.diff(pt.csr_start))[0]
    for w in occupied.tolist():
        positions = pt.positions_for(w)
        if len(positions) == 0:
            continue
        out.write("%0*X/%s:" % (hex_width, w, packed_to_string(seed, w)))
        if show_counts:
            out.write(" %d" % len(positions))
        if show_positions:
            out.write(" " + ",".join(str(int(p)) for p in positions))
        out.write("\n")


def position_table_count_distribution(pt: PositionTable):
    """(count, occurrences) pairs, ascending (reference
    position_table_count_distribution, pos_table.c)."""
    counts = np.diff(pt.csr_start)
    counts = counts[counts > 0]
    values, occurrences = np.unique(counts, return_counts=True)
    return list(zip(values.tolist(), occurrences.tolist()))
