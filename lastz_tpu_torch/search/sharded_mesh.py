"""Interval-sharded target search over device slots: the lastz_32/lastz_40
beyond-memory tier (reference src/Makefile:19-25, pos_table.c:118).
Port of lastz_tpu/search/sharded_mesh.py, whose shard_map program over a
jax.sharding.Mesh becomes a loop over SHARD_SLOTS.

The host may hold the whole target (the reference's wide-index builds
run on big-memory hosts too); the DEVICES never do.  Each device slot
owns one interval shard of index/sharded.py's contract:

  * its CSR position table, built from only its slice + L-1 halo;
  * its compact-alphabet target codes over the slice plus an
    EXT_HALO-wide extension halo on each side.

One program per shard (probe + expand + gap-free x-drop extension
through K2, ops/xdrop_cuda.xdrop_scan) runs on the shard's own slot:
each shard probes ITS CSR with the (replicated, small) query words and
extends every candidate against ITS resident slice, clamped to the
halo.  Every shard is launched before any result is read; candidates
come back as fixed-size per-shard buffers, and the host reads only the
overflow flags and the kept counts before it fetches the kept part.  It
merges them into the reference's exact enumeration order (query
position ascending, probe order, target position descending = sort by
(pair index, -pos1); shard position sets are disjoint) and replays the
sequential 64K diagonal-hash drop protocol + reporting exactly as
search/batched.py does (process_for_simple_hit,
seed_search.c:1056-1198).

Halo-gather at borders: a candidate whose extension consumed its
whole clamped range while the true range continues past the resident
halo is re-extended against a window GATHERED from the owning shards'
device slices (never from a host copy of the target); the window
doubles until the scan terminates inside it.  Hits needing it are rare
(an extension must survive EXT_HALO bases without dropping).

Exactness: extension is speculative and unconstrained (identical to
the batched host path), the drop protocol runs on the merged stream
in reference order, and the rare left-blocked re-extension falls back
to the scalar engine, so results are hit-for-hit identical to the
scalar oracle (tests/test_torch_sharded.py).

Device slots: shard d lives on SHARD_SLOTS[d] (a list of devices, "cpu"
or "cuda:i"; a card may be listed more than once).  None means every
visible card under LASTZ_TORCH_DEVICE=cuda and one "cpu" slot under
cpu.  A slot on a card runs its launches on the calling thread's
current stream there.  With fewer slots than shards the route declines
and the standard tiers run.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..config import GFEX_XDROP
from ..device import SEQ_PAD, content_key, get_device, resolve_device
from ..index.postable import _window_words
from ..index.sharded import build_sharded_position_table
from ..ops.hitgen import pair_counts, expand_chunk
from ..ops.xdrop_cuda import xdrop_scan
from ..ops.ydrop_exact import make_compact_alphabet
from .batched import (DIAG_HASH_SIZE, HASH_INACTIVE, MIN64, _probe_xors,
                      _resolve_chains)
from .replay import Replay

# extension halo (bases) resident beyond each shard's owned interval;
# overridable for tests that force the halo-gather path
EXT_HALO = int(os.environ.get("LASTZ_TORCH_SHARD_HALO", "32768"))
OUT_ROWS = 9  # pos1, k, lb, lk, rb, rk, lc, rc, eflag
# candidate buffer a shard and range; a range whose candidates overflow
# it is split in halves (tests patch it to force the split)
CAP = 1 << 15
# the shards' device slots (see the module docstring)
SHARD_SLOTS = None

_I32 = torch.int32
_I64 = torch.int64


def shard_slots() -> list[torch.device]:
    """SHARD_SLOTS resolved, or its default (every visible card, or the
    CPU, by LASTZ_TORCH_DEVICE)."""
    if SHARD_SLOTS is not None:
        return [resolve_device(d) for d in SHARD_SLOTS]
    dev = get_device()
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def slot_context(device):
    """The block's launches go to `device`: on a card, it is the calling
    thread's current card (the kernels' C entry points launch there, on
    its current stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class MeshShardedIndex:
    """Per-slot shard residency: shard d's CSR and compact slice codes
    are tensors on slots[d] only, in lastz_tpu's padded layout (every
    shard's codes cmax long, its csr_pos pmax long)."""

    def __init__(self, seq1_v, char_to_bits, seed, step, n_shards,
                 sub, ext_halo=None, slots=None):
        self.halo = EXT_HALO if ext_halo is None else int(ext_halo)
        self.seed = seed
        self.step = step
        self.n = len(seq1_v)
        sh = build_sharded_position_table(
            seq1_v, char_to_bits, seed, step, n_shards)
        self.n_shards = len(sh.shards)
        slots = shard_slots() if slots is None else \
            [resolve_device(d) for d in slots]
        if len(slots) < self.n_shards:
            raise ValueError(
                f"need {self.n_shards} device slots, have {len(slots)}")
        self.slots = slots[: self.n_shards]
        cmap = make_compact_alphabet([seq1_v], sub, max_k=16)
        if cmap is None:
            raise ValueError("alphabet too wide for the device path")
        self.code_map, self.subsmall = cmap
        self.K = self.subsmall.shape[0]

        S = self.n_shards
        nw = 1 << seed.weight
        pmax = max(int(len(p.csr_pos)) for p in sh.shards)
        res_lo = np.zeros(S, np.int64)
        res_hi = np.zeros(S, np.int64)
        for d, pt in enumerate(sh.shards):
            # owned word-end interval (start, end]; resident codes add
            # the extension halo on both sides
            res_lo[d] = max(0, pt.start - self.halo)
            res_hi[d] = min(self.n, pt.end + self.halo)
        cmax = int((res_hi - res_lo).max()) + 2 * SEQ_PAD
        self.cmax = cmax
        self.res_lo = res_lo
        self.res_hi = res_hi
        self.adj = np.array([pt.adj_start for pt in sh.shards], np.int64)
        # non-overlapping cover ranges for window gathering
        self.cov = np.zeros(S + 1, np.int64)
        self.cov[1:-1] = [sh.shards[d].end for d in range(S - 1)]
        self.cov[-1] = self.n
        self.csr_start_d, self.csr_pos_d, self.codes_d = [], [], []
        for d, pt in enumerate(sh.shards):
            csr_pos = np.zeros(max(pmax, 1), np.int32)
            csr_pos[: len(pt.csr_pos)] = pt.csr_pos
            codes = np.zeros(cmax, np.int8)
            span = res_hi[d] - res_lo[d]
            codes[SEQ_PAD: SEQ_PAD + span] = \
                self.code_map[seq1_v[res_lo[d]: res_hi[d]]]
            dev = self.slots[d]
            self.csr_start_d.append(torch.from_numpy(
                np.ascontiguousarray(pt.csr_start, np.int32)).to(dev))
            self.csr_pos_d.append(torch.from_numpy(csr_pos).to(dev))
            self.codes_d.append(torch.from_numpy(codes).to(dev))
        # the largest target-derived bytes any one slot holds (the "no
        # device holds the whole target" budget, asserted in tests)
        self.per_device_target_bytes = int(
            cmax + 4 * pmax + 4 * (nw + 1))

    def gather_codes(self, lo: int, hi: int) -> np.ndarray:
        """Assemble compact codes for absolute range [lo, hi) from the
        owning shards' DEVICE slices (the halo-gather; the host target
        array is never consulted)."""
        lo = max(lo, 0)
        hi = min(hi, self.n)
        out = np.zeros(hi - lo, np.int8)
        for d in range(self.n_shards):
            a = max(lo, int(self.cov[d]))
            b = min(hi, int(self.cov[d + 1]))
            if a >= b:
                continue
            o = SEQ_PAD + (a - int(self.res_lo[d]))
            out[a - lo: b - lo] = self.codes_d[d][o: o + (b - a)].cpu().numpy()
        return out


# ---------------------------------------------------------------------------
# the per-shard program
# ---------------------------------------------------------------------------


def _shard_probe_extend(csr_start, csr_pos, adj, codes, res_lo, res_hi,
                        packed, valid, xors, subflat, qcodes, dyn, *, CAP,
                        K, nprobe, L, step, PCH, self_compare, same_strand):
    """One shard's probe + expand + both-way x-drop over its resident
    tensors (lastz_tpu's shard_map body, :166-239).  dyn: (chunk_lo,
    p_lo, p_hi, x_drop, len1, len2, band).  Returns (out (OUT_ROWS, CAP)
    int32, n_keep, overflow), 0-d tensors on the shard's device; nothing
    is read on the host."""
    chunk_lo, p_lo, p_hi, x_drop, len1, len2, band = dyn
    dev = codes.device
    pk = packed[chunk_lo: chunk_lo + PCH]
    widx = torch.arange(PCH, device=dev)
    vd = valid[chunk_lo: chunk_lo + PCH] & (widx >= p_lo) & (widx < p_hi)

    cum, ends, tot = pair_counts(pk, vd, xors, csr_start)
    karr = expand_chunk(cum, CAP)
    i = torch.arange(CAP, dtype=_I64, device=dev)
    live = i < torch.clamp(tot, max=CAP)
    overflow = tot > CAP

    k = torch.clamp(karr, 0, ends.shape[0] - 1)
    within = i - cum[k]
    pidx = torch.div(k, nprobe, rounding_mode="floor")
    csr_idx = torch.clamp(ends[k] - 1 - within, 0, csr_pos.shape[0] - 1)
    pos1 = adj + step * csr_pos[csr_idx].to(_I64)
    pos2 = chunk_lo + L + pidx
    if self_compare:
        if same_strand:
            live = live & (pos1 < pos2)
        else:
            live = live & ((pos1 - L) < (len2 - 1) - (pos2 - L))
    if same_strand:
        live = live & ((pos2 - pos1) <= band)

    diag = pos1 - pos2
    n_l_true = torch.where(live, pos1 - torch.clamp(diag, min=0), 0)
    stop1r = torch.clamp(len2 + diag, max=len1)
    n_r_true = torch.where(live, torch.clamp(stop1r - pos1, min=0), 0)
    # K2 takes shard-relative target positions into the padded slice
    p1loc = pos1 - res_lo
    n_l = torch.clamp(torch.minimum(n_l_true, p1loc), min=0)
    n_r = torch.clamp(torch.minimum(n_r_true, res_hi - pos1), min=0)
    (lc, lb, lk), (rc, rb, rk) = xdrop_scan(
        codes, qcodes, subflat, K, p1loc, pos2, n_l, n_r, x_drop)
    lc, lb, lk, rc, rb, rk = (a.to(_I64) for a in (lc, lb, lk, rc, rb, rk))
    # halo clamp reached while still consuming: the exact result needs
    # the neighbour's bases (conservative: lc == n_l also matches scans
    # that ended exactly at the clamp; the re-extension is identical)
    edge = (((lc >= n_l) & (n_l < n_l_true)).to(_I64)
            | (((rc >= n_r) & (n_r < n_r_true)).to(_I64) << 1))
    edge = torch.where(live, edge, 0)

    # in-order compaction with no host read: dead hits go to column CAP
    idx = torch.cumsum(live.to(_I64), 0) - 1
    n_keep = live.sum()
    dst = torch.where(live & (idx < CAP), idx, CAP)
    out = torch.zeros((OUT_ROWS, CAP + 1), dtype=_I32, device=dev)
    rows = (pos1, k, lb, lk, rb, rk, lc, rc, edge)
    out[:, dst] = torch.stack(rows).to(_I32)
    return out[:, :CAP], n_keep, overflow


def _mesh_program(index: MeshShardedIndex, inputs, dyn, statics: dict):
    """Every shard's program on its own slot, all launched before any
    result is read; returns one (out, n_keep, overflow) a shard.
    inputs[d] holds the query-side tensors on slot d."""
    outs = []
    for d in range(index.n_shards):
        with slot_context(index.slots[d]):
            outs.append(_shard_probe_extend(
                index.csr_start_d[d], index.csr_pos_d[d],
                int(index.adj[d]), index.codes_d[d], int(index.res_lo[d]),
                int(index.res_hi[d]), *inputs[d], dyn, **statics))
    return outs


# ---------------------------------------------------------------------------
# halo-gather re-extension (rare border hits)
# ---------------------------------------------------------------------------


def _scan_gathered(index, qcodes_np, subflat, K, p1, p2, n_true,
                   x_drop, step):
    """Sequential x-drop scan for ONE hit against windows gathered
    from the owning shards' device slices; the window doubles until
    the scan terminates inside it or the true bound is reached.
    Returns (consumed, best, kbest), the contract of K2."""
    W = 2 * index.halo
    while True:
        n_win = min(n_true, W)
        if step > 0:
            w = index.gather_codes(p1, p1 + n_win).astype(np.int64)
            q = qcodes_np[p2: p2 + n_win].astype(np.int64)
        else:
            w = index.gather_codes(p1 - n_win + 1,
                                   p1 + 1)[::-1].astype(np.int64)
            q = qcodes_np[p2 - n_win + 1: p2 + 1][::-1].astype(np.int64)
        s = subflat[w * K + q]
        c = np.cumsum(s)
        m = np.maximum.accumulate(np.maximum(c, 0))
        bad = c < m - x_drop
        if bad.any():
            stop = int(np.argmax(bad)) + 1
            c = c[:stop]
            consumed = stop
            done = True
        else:
            consumed = n_win
            done = n_win >= n_true
        if done:
            if len(c) == 0:
                return 0, 0, -1
            best = int(c.max())
            kbest = int(np.argmax(c)) if best > 0 else -1
            return consumed, best, kbest
        W *= 2


# ---------------------------------------------------------------------------
# search orchestration
# ---------------------------------------------------------------------------


def supported(engine) -> bool:
    hp = engine.hp
    if engine.hit_mode != "simple" or hp.gf_extend != GFEX_XDROP:
        return False
    if hp.pos_filter or hp.min_matches >= 0:
        return False
    if engine.seed.type == "R" or engine.seed.rev_comp:
        return False
    if engine.pt.alive is not None:
        return False  # dynamic masking mutates the index mid-run
    sub = engine._sub
    if sub is None or sub.dtype != np.int64 \
            or np.abs(sub).max() >= (1 << 30):
        return False
    if max(len(engine.seq1), len(engine.seq2)) >= (1 << 31):
        return False
    return True


_INDEX_CACHE: dict = {}


def mesh_search_via_env(engine, n_shards: int, start: int = 0,
                        end: int = 0):
    """LASTZ_TORCH_SHARDS=N routing: build (and cache per target, seed
    and slots) the sharded index and search through it; returns None
    when the configuration is unsupported or there are fewer slots
    than shards (the standard tiers take over)."""
    if not supported(engine):
        return None
    slots = shard_slots()
    if len(slots) < n_shards:
        return None
    seed = engine.seed
    # keyed on the target's content, never on id(): a multi-target
    # run's next target can reuse a freed array's id
    key = (content_key(engine.seq1, engine.char_to_bits, engine._sub),
           seed.weight, seed.length, tuple(seed.bit_map), engine.pt.step,
           n_shards, EXT_HALO, tuple(str(s) for s in slots[:n_shards]))
    index = _INDEX_CACHE.get(key)
    if index is None:
        from .. import stats as st_mod
        with st_mod.current.time("shard index build"):
            index = MeshShardedIndex(
                engine.seq1, engine.char_to_bits, seed,
                engine.pt.step, n_shards, engine._sub, slots=slots)
        if len(_INDEX_CACHE) > 4:
            _INDEX_CACHE.clear()
        _INDEX_CACHE[key] = index
    return sharded_mesh_search(engine, index, start, end)


def sharded_mesh_search(engine, index: MeshShardedIndex,
                        start: int = 0, end: int = 0):
    """Drop-in engine.search replacement over a sharded index; returns
    bases_hit, or None when unsupported (scalar/batched paths take
    over).  Hit-for-hit identical to the scalar oracle."""
    if not supported(engine):
        return None

    if end == 0:
        end = len(engine.seq2)
    seed = engine.seed
    L = seed.length
    if end - start < L:
        return 0
    hp = engine.hp
    x_drop = int(hp.x_drop)

    # query words (host, replicated to every slot)
    codes2 = engine.char_to_bits[engine.seq2[start:end]]
    words, valid_np = _window_words(codes2, L, seed.bits_per_base)
    packed_np = seed.pack(words).astype(np.int64)
    xors_np = _probe_xors(seed).astype(np.int64)
    nprobe = len(xors_np)
    num_w = len(packed_np)

    subflat_np = np.ascontiguousarray(
        index.subsmall.reshape(-1).astype(np.int32))
    qc = np.zeros(len(engine.seq2) + 2 * SEQ_PAD, np.int8)
    qc[SEQ_PAD: SEQ_PAD + len(engine.seq2)] = \
        index.code_map[engine.seq2]

    PCH = 1 << 14
    n_chunks = (num_w + PCH - 1) // PCH
    pad = n_chunks * PCH - num_w
    host_in = (np.concatenate([packed_np, np.zeros(pad, np.int64)]),
               np.concatenate([valid_np, np.zeros(pad, bool)]),
               xors_np, subflat_np, qc)
    on_dev = {}
    inputs = []
    for dev in index.slots:
        if str(dev) not in on_dev:
            on_dev[str(dev)] = [torch.from_numpy(np.ascontiguousarray(a))
                                .to(dev) for a in host_in]
        inputs.append(on_dev[str(dev)])
    qcodes_np_small = qc[SEQ_PAD: SEQ_PAD + len(engine.seq2)]

    statics = dict(CAP=CAP, K=index.K, nprobe=nprobe, L=L, step=index.step,
                   PCH=PCH, self_compare=bool(engine.self_compare),
                   same_strand=bool(engine.same_strand))
    band = engine.band_width if (engine.same_strand
                                 and engine.band_width > 0) else (1 << 30)

    from .. import stats as st_mod
    st = st_mod.current
    st.words_in_queries += int(valid_np.sum())

    de = engine.diag_end
    thresh_is_score = hp.hsp_threshold.t == "S"
    thresh = hp.hsp_threshold.s
    seq1 = engine.seq1
    seq2 = engine.seq2
    rp = Replay(engine, restore=True)

    def run_ranges(chunk_lo):
        """Per-shard candidate buffers for window range [p_lo, p_hi)
        of one chunk, splitting on overflow."""
        parts = []
        ranges = [(0, PCH)]
        while ranges:
            p_lo, p_hi = ranges.pop(0)
            dyn = (chunk_lo, p_lo, p_hi, x_drop, len(seq1), len(seq2),
                   band)
            with st.time("shard search"):
                outs = _mesh_program(index, inputs, dyn, statics)
                # the one host read of the range: each shard's kept
                # count and overflow flag
                flags = np.array([torch.stack([n_keep, ovf.to(_I64)])
                                  .tolist() for _, n_keep, ovf in outs])
            if flags[:, 1].any():
                mid = (p_lo + p_hi) // 2
                if mid == p_lo:
                    return None  # one position overflows CAP
                ranges[:0] = [(p_lo, mid), (mid, p_hi)]
                continue
            parts.append([o[:, : nk].cpu().numpy()
                          for (o, _, _), nk in zip(outs, flags[:, 0])])
        return parts

    for c in range(n_chunks):
        parts = run_ranges(c * PCH)
        if parts is None:
            return None
        bufs = [b for pr in parts for b in pr if b.shape[1]]
        if not bufs:
            continue
        cat = np.concatenate(bufs, axis=1)
        (pos1a, ka, lb, lk, rb, rk, lc, rc, edge) = \
            [cat[r].astype(np.int64) for r in range(OUT_ROWS)]
        # reference enumeration order: (pair index asc, pos1 desc);
        # shard position sets are disjoint so this is a total order
        order0 = np.lexsort((-pos1a, ka))
        (pos1a, ka, lb, lk, rb, rk, lc, rc, edge) = \
            [a[order0] for a in (pos1a, ka, lb, lk, rb, rk, lc, rc,
                                 edge)]
        pidx = ka // nprobe
        pos2a = c * PCH + L + pidx + start
        diag_a = pos1a - pos2a

        extent = pos1a + rc - diag_a
        grp = pidx  # window index: monotone with enumeration order

        # drop protocol: the simple-mode replay of
        # search/batched.py:493-625 over the merged stream.  Chains
        # free of border-clamped extents run the vectorized fixpoint;
        # chains containing one are walked sequentially with LAZY
        # halo-gather re-extension: only hits the protocol actually
        # accepts pay for a gathered re-scan, exactly the extensions
        # the scalar engine would have performed (hits dropped by the
        # chain never need their true extent: dropped hits contribute
        # nothing to the running max).
        H = len(pos1a)
        h_a = (diag_a & (DIAG_HASH_SIZE - 1)).astype(np.int64)
        order = np.argsort(h_a, kind="stable")
        hs = h_a[order]
        seg_start = np.ones(H, bool)
        seg_start[1:] = hs[1:] != hs[:-1]
        seg_first = np.nonzero(seg_start)[0]
        touched_h = hs[seg_first]
        seg_id = np.cumsum(seg_start) - 1
        lazy_seg = np.zeros(len(seg_first), bool)
        np.logical_or.at(lazy_seg, seg_id, edge[order] != 0)
        de0 = de[hs]
        de0 = np.where(de0 == HASH_INACTIVE, 0, de0)
        vec = ~lazy_seg[seg_id]
        extent_s = extent[order].copy()
        alive_s = np.zeros(H, bool)
        de_before_s = np.zeros(H, np.int64)
        if vec.any():
            res = _resolve_chains(
                np.where(vec, extent_s, MIN64),
                np.where(vec, (pos2a - L)[order], np.int64(1 << 60)),
                np.where(vec, de0, 0), seg_start)
            if res is None:
                return None
            alive_s[vec], de_before_s[vec] = (res[0][vec],
                                              res[1][vec])
        seg_end = np.concatenate([seg_first[1:], [H]])
        for s in np.nonzero(lazy_seg)[0]:
            cur = int(de0[seg_first[s]])
            for j in range(seg_first[s], seg_end[s]):
                i = int(order[j])
                ok = cur <= int(pos2a[i]) - L
                alive_s[j] = ok
                de_before_s[j] = cur
                if not ok:
                    continue
                p1 = int(pos1a[i])
                p2 = int(pos2a[i])
                d = int(diag_a[i])
                if edge[i] & 1:
                    n_true = p1 - max(d, 0)
                    lc[i], lb[i], lk[i] = _scan_gathered(
                        index, qcodes_np_small, subflat_np, index.K,
                        p1 - 1, p2 - 1, n_true, x_drop, -1)
                if edge[i] & 2:
                    n_true = max(
                        min(len(seq1), len(seq2) + d) - p1, 0)
                    rc[i], rb[i], rk[i] = _scan_gathered(
                        index, qcodes_np_small, subflat_np, index.K,
                        p1, p2, n_true, x_drop, +1)
                if edge[i]:
                    st.extra["shard halo-gathers"] = \
                        st.extra.get("shard halo-gathers", 0) + 1
                    edge[i] = 0
                    extent_s[j] = p1 + int(rc[i]) - d
                cur = max(cur, int(extent_s[j]))

        # the extension's left score and start, right score and stop
        scores = (np.where(lb > 0, lb, 0),
                  np.where(lb > 0, pos1a - 1 - lk, pos1a),
                  np.where(rb > 0, rb, 0),
                  np.where(rb > 0, pos1a + rk + 1, pos1a))

        contrib = np.where(alive_s, extent_s, MIN64)
        seg_max = np.maximum.reduceat(
            np.maximum(contrib, de0), seg_first)
        de[touched_h] = np.maximum(de[touched_h], seg_max)
        de[touched_h] = np.where(
            de[touched_h] == HASH_INACTIVE, 0, de[touched_h])
        alive = np.zeros(H, bool)
        alive[order] = alive_s
        de_before = np.zeros(H, np.int64)
        de_before[order] = de_before_s

        stop1_blk = np.maximum(de_before + diag_a, 0)
        bind = alive & (lc > pos1a - stop1_blk)
        sim_raw = scores[0] + scores[2]
        if thresh_is_score and thresh > 0:
            cand_mask = alive & (bind | (sim_raw >= thresh))
        else:
            cand_mask = alive

        st.raw_seed_hits += H
        st.hash_dropped_hits += int((~alive).sum())
        st.ungapped_extensions += int(alive.sum())

        cand = np.flatnonzero(cand_mask)
        ok = rp.rows(pos1a[cand], pos2a[cand], grp[cand],
                     *(a[cand] for a in scores), de_before[cand],
                     bind[cand])
        if not ok or rp.stop(c < n_chunks - 1):
            return rp.bases_hit

    rp.stop()
    return rp.bases_hit
