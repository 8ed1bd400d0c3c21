"""Seed-hit search with diagonal filtering and gap-free extension.

This is the EXACT host engine: it reproduces, hit for hit, the
reference's seed search semantics (seed_search.c:322-3560), which are
observable in golden outputs:

  * query scanned left to right; at each end position the exact packed
    word is probed first, then transition-flipped variants in packed-
    bit order (seed_search.c:464-579);
  * per probe, target positions are enumerated in DESCENDING order
    (the last/prev chain of the position table);
  * the 64K diagonal hash "suffers" collisions on purpose: a hit whose
    hashed diagonal has already been extended past the hit's start is
    dropped even when the collision is with a different true diagonal
    (process_for_simple_hit, seed_search.c:1056-1198);
  * x-drop gap-free extension starts at the RIGHT end of the seed hit,
    scans left (blocked at the previous extent on the hashed diagonal)
    then right; the recorded diagonal extent is where the right scan
    stopped, not the trimmed HSP end (xdrop_extend_seed_hit,
    seed_search.c:2528-2960);
  * marginal scores are entropy-adjusted (dna_utilities.c:2882).

A batched TPU path (ops/) accelerates the same math; this engine is
the source of truth and the oracle for its tests.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..core.scoring import ScoreSet
from ..core.seeds import Seed
from ..index.postable import PositionTable, _window_words
from ..config import (
    GFEX_NO_EXTEND,
    GFEX_XDROP,
    GFEX_EXACT,
    GFEX_MISMATCH_BASE,
    ScoreThreshold,
)
from .replay import hsp

DIAG_HASH_SIZE = 65536
HASH_INACTIVE = -1

_POPCOUNT16 = np.array(
    [bin(i).count("1") for i in range(1 << 16)], dtype=np.int32)

NO_SCORE = None  # sentinel for "discard this hit"


@dataclass
class HitProcessorParams:
    gf_extend: int = GFEX_XDROP
    scoring: Optional[ScoreSet] = None  # masked scoring for HSP stage
    x_drop: int = 0
    hsp_threshold: ScoreThreshold = field(default_factory=lambda: ScoreThreshold("S", 3000))
    hsp_zero_threshold: int = 0
    entropic_hsp: bool = True
    report_entropy: bool = False
    min_matches: int = -1
    max_transversions: int = -1
    filter_pattern: Optional[str] = None  # seed pattern for cares-only filter
    # positional filter (chores)
    pos_filter: bool = False
    target_interval: tuple = (0, 0)
    query_interval: tuple = (0, 0)
    # mismatch extension params
    num_mismatches: int = 0


class SeedSearchEngine:
    """One (target, query-strand) search pass.

    reporter(pos1, pos2, length, score) is called for each surviving
    hit/HSP, where pos1/pos2 are END positions (origin-0 exclusive).
    It must return a nonzero value if the hit was 'counted' (for
    search-limit accounting).
    """

    def __init__(
        self,
        seq1_v: np.ndarray,
        pt: PositionTable,
        seq2_v: np.ndarray,
        seed: Seed,
        upper_char_to_bits: np.ndarray,
        params: HitProcessorParams,
        reporter: Callable[[int, int, int, int], int],
        self_compare: bool = False,
        same_strand: bool = False,
        search_limit: int = 0,
        hit_mode: str = "simple",  # 'plain' | 'simple' | 'recover' | 'twin'
        twin_min_span: int = 0,
        twin_max_span: int = 0,
        anchors=None,  # segment table, for adaptive-threshold entropy rule
        seed_queue_size: int = 256 * 1024,  # --seedqueue (diag_hash.h:106)
        on_limit_exceeded: Optional[Callable[[], None]] = None,
        band_width: int = 0,  # --band= (seed_search.c:845,907)
        device=None,  # torch device of the seed search; None: host tiers
        target_state=None,  # the run's device.TargetState, for seq1_v and pt
    ):
        self.seq1 = seq1_v
        self.pt = pt
        self.seq2 = seq2_v
        self.seed = seed
        self.char_to_bits = upper_char_to_bits
        self.hp = params
        self.reporter = reporter
        self.self_compare = self_compare
        self.same_strand = same_strand
        self.search_limit = search_limit
        self.search_to_go = search_limit
        self.hit_mode = hit_mode
        self.band_width = band_width
        self.twin_min_span = twin_min_span
        self.twin_max_span = twin_max_span
        self.anchors = anchors
        self.device = device
        self.target_state = target_state
        if seed_queue_size > 0:
            self.SEED_HIT_QUEUE_SIZE = seed_queue_size

        self.diag_end = np.full(DIAG_HASH_SIZE, HASH_INACTIVE, dtype=np.int64)
        self.diag_start = np.zeros(DIAG_HASH_SIZE, dtype=np.int64)
        self.diag_actual = np.zeros(DIAG_HASH_SIZE, dtype=np.int64)
        self._unblocked_left = False
        self.limit_exceeded = False
        self.on_limit_exceeded = on_limit_exceeded

        # hot lookups
        self._sub = params.scoring.sub if params.scoring is not None else None

        # native x-drop kernel (exact speedup; see native/ydrop_row.cpp)
        self._native = None
        if self._sub is not None and self._sub.dtype == np.int64:
            from ..native import get_lib
            lib = get_lib()
            if lib is not None:
                import ctypes
                self._native = (lib, ctypes)

    # -- main loop --------------------------------------------------------

    def search(self, start: int = 0, end: int = 0) -> int:
        n_shards = int(os.environ.get("LASTZ_TORCH_SHARDS", "0"))
        if n_shards > 1:
            # interval-sharded search (targets past one device's
            # memory): the index shards live one a device slot;
            # configurations it declines take the tiers below
            from .sharded_mesh import mesh_search_via_env
            r = mesh_search_via_env(self, n_shards, start, end)
            if r is not None:
                return r
        if self.device is not None:
            # the device search (search/device_hits.py); configurations
            # its supported() gate declines take the host tiers below,
            # counted in --stats.  A device failure propagates.
            from .device_hits import device_search
            r = device_search(self, self.device, start, end)
            if r is not None:
                return r
            from .. import stats as _stats
            x = _stats.current.extra
            x["seed host searches"] = x.get("seed host searches", 0) + 1
        from .native_sweep import native_hit_search
        r = native_hit_search(self, start, end)
        if r is not None:
            return r
        from .batched import batched_search
        r = batched_search(self, start, end)
        if r is not None:
            return r
        if (end or len(self.seq2)) - start > 200_000 \
                and not getattr(SeedSearchEngine,
                                "_scalar_warned", False):
            SeedSearchEngine._scalar_warned = True
            import sys
            sys.stderr.write(
                "lastz_tpu: this configuration (hit mode '%s', "
                "seed type '%s') uses the per-base scalar search "
                "path, which is slow at this scale\n"
                % (self.hit_mode, self.seed.type))
        if end == 0:
            end = len(self.seq2)
        seed = self.seed
        L = seed.length
        if end - start < L:
            return 0
        codes = self.char_to_bits[self.seq2[start:end]]
        words, valid = _window_words(codes, L, seed.bits_per_base)
        packed_all = seed.pack(words)
        # positions where a word ends (origin-0 exclusive end position)
        bases_hit = 0
        flips = seed.trans_flips if seed.with_trans else ()
        with_trans = seed.with_trans
        resolve = seed.type == "R"
        if resolve:
            resolve_all = seed.pack_resolve(words)
        valid_idx = np.nonzero(valid)[0]
        for k in valid_idx:
            pos2 = start + L + int(k)
            packed = int(packed_all[k])
            if resolve:
                # flipped probes spend transition budget in the index,
                # leaving less for the resolving bits
                # (private_hit_search_resolve, seed_search.c:700-780)
                q_res = int(resolve_all[k])
                bases_hit += self._probe_resolve(
                    packed, pos2, q_res, with_trans)
                if with_trans == 1:
                    for f in flips:
                        bases_hit += self._probe_resolve(
                            packed ^ f, pos2, q_res, 0)
                elif with_trans >= 2:
                    nf = len(flips)
                    for i in range(nf):
                        p1 = packed ^ flips[i]
                        bases_hit += self._probe_resolve(p1, pos2, q_res, 1)
                        for j in range(i + 1, nf):
                            bases_hit += self._probe_resolve(
                                p1 ^ flips[j], pos2, q_res, 0)
            else:
                bases_hit += self._probe(packed, pos2)
                if with_trans == 1:
                    for f in flips:
                        bases_hit += self._probe(packed ^ f, pos2)
                elif with_trans >= 2:
                    nf = len(flips)
                    for i in range(nf):
                        p1 = packed ^ flips[i]
                        bases_hit += self._probe(p1, pos2)
                        for j in range(i + 1, nf):
                            bases_hit += self._probe(p1 ^ flips[j], pos2)
            if self.search_limit > 0 and self.search_to_go < 0:
                self._trip_limit()
                return bases_hit
        return bases_hit

    def search_quantum(self, ball_score, start: int = 0, end: int = 0) -> int:
        """Quantum-query seed search (reference quantum_seed_hit_search,
        quantum.c:128): for each query position, enumerate the 'ball'
        of DNA words scoring >= ball_score against the quantum word
        (branch-and-bound, here as pruned per-level numpy expansion in
        the same ascending packed order as the reference's DFS), and
        probe the position table for each."""
        seed = self.seed
        if seed.type != "S" or seed.with_trans != 0:
            raise SystemExit(
                "FAILURE: quantum DNA requires a strict seed without"
                " transitions")
        if end == 0:
            end = len(self.seq2)
        L = seed.length
        if end - start < L:
            return 0
        w = seed.weight // 2  # number of match positions
        # packed-base -> window-offset map, from the seed's bit map
        # (equivalent to the reference's seed_shuffle_list, seeds.c:1107)
        offsets = [None] * w
        for src, dst in seed.bit_map:
            if dst % 2 == 0:
                offsets[dst // 2] = L - 1 - src // 2
        if any(o is None for o in offsets):
            raise SystemExit(
                "FAILURE: quantum seeding couldn't derive the seed's"
                " match-position layout")
        # DFS levels assign the packed word MSB-first
        level_offsets = [offsets[w - 1 - i] for i in range(w)]

        from .batched import batched_search_quantum
        r = batched_search_quantum(self, ball_score, start, end)
        if r is not None:
            return r

        sub = self._sub
        # ball citizens are DNA for DNA rows, else bottleneck symbols
        # (quantum.c:184-185)
        ss = self.hp.scoring
        if ss is not None and not ss.rows_are_dna and ss.bottleneck:
            sym_codes = np.frombuffer(
                ss.bottleneck, dtype=np.uint8).astype(np.int64)
        else:
            sym_codes = np.frombuffer(
                b"ACGT", dtype=np.uint8).astype(np.int64)
        four = np.arange(4, dtype=np.int64)
        v2 = self.seq2
        bases_hit = 0
        for qpos_end in range(start + L, end + 1):
            wstart = qpos_end - L
            lvl_scores = [sub[sym_codes, int(v2[wstart + off])]
                          for off in level_offsets]
            best = [ls.max() for ls in lvl_scores]
            if sum(best) < ball_score:
                continue
            min_needed = [0] * w
            min_needed[w - 1] = ball_score
            for i in range(w - 1, 0, -1):
                min_needed[i - 1] = min_needed[i] - best[i]
            packed = np.zeros(1, dtype=np.int64)
            scores = np.zeros(1, dtype=sub.dtype)
            for i in range(w):
                packed = (packed[:, None] * 4 + four).ravel()
                scores = (scores[:, None] + lvl_scores[i]).ravel()
                keep = scores >= min_needed[i]
                packed = packed[keep]
                scores = scores[keep]
                if len(packed) == 0:
                    break
            for word in packed.tolist():
                bases_hit += self._probe(int(word), qpos_end)
            if self.search_limit > 0 and self.search_to_go < 0:
                self._trip_limit()
                return bases_hit
        return bases_hit

    def _probe(self, packed: int, pos2: int) -> int:
        pt = self.pt
        lo = pt.csr_start[packed]
        hi = pt.csr_start[packed + 1]
        if lo == hi:
            return 0
        bases_hit = 0
        adj = pt.adj_start
        step = pt.step
        csr = pt.csr_pos
        alive = pt.alive
        band = self.band_width
        for i in range(hi - 1, lo - 1, -1):
            if alive is not None and not alive[i]:
                continue
            pos1 = adj + step * int(csr[i])
            if self.self_compare and self._below_diagonal(pos1, pos2):
                continue
            if (self.same_strand and band > 0 and pos2 - pos1 > band):
                continue  # seed hit too far from main diagonal
            bases_hit += self._process(pos1, pos2, self.seed.length)
        return bases_hit

    def _probe_resolve(self, packed: int, pos2: int, q_resolve: int,
                       trans_allowed: int) -> int:
        """Overweight seeds: verify demoted bits against the target's
        precomputed per-entry resolve words (seed_search.c:878-980)."""
        pt = self.pt
        lo = pt.csr_start[packed]
        hi = pt.csr_start[packed + 1]
        if lo == hi:
            return 0
        bases_hit = 0
        adj = pt.adj_start
        step = pt.step
        csr = pt.csr_pos
        L = self.seed.length
        xor = pt.csr_resolve[lo:hi] ^ np.uint32(q_resolve)
        mism = _POPCOUNT16[xor & 0xFFFF] + _POPCOUNT16[xor >> 16]
        ok = mism <= trans_allowed
        if pt.alive is not None:
            ok = ok & pt.alive[lo:hi]
        band = self.band_width
        for k in range(hi - 1 - lo, -1, -1):
            if not ok[k]:
                continue
            pos1 = adj + step * int(csr[lo + k])
            if self.self_compare and self._below_diagonal(pos1, pos2):
                continue
            if (self.same_strand and band > 0 and pos2 - pos1 > band):
                continue  # seed hit too far from main diagonal
            bases_hit += self._process(pos1, pos2, L)
        return bases_hit

    def _below_diagonal(self, pos1: int, pos2: int) -> bool:
        """reference seed_hit_below_diagonal: for self-comparisons,
        suppress hits on or below the main diagonal (mirrors are added
        back by mirroring the surviving alignments)."""
        if self.same_strand:
            return pos1 >= pos2
        p1 = pos1 - self.seed.length
        p2 = pos2 - self.seed.length
        # (partitioned variant handled by the pipeline's partition maps)
        p2 = (len(self.seq2) - 1) - p2
        return p1 >= p2

    # -- hit processors ----------------------------------------------------

    def _process(self, pos1: int, pos2: int, length: int) -> int:
        if self.hit_mode == "plain":
            return self._process_plain(pos1, pos2, length)
        if self.hit_mode == "recover":
            return self._process_recover(pos1, pos2, length)
        if self.hit_mode == "twin":
            return self._process_twin(pos1, pos2, length)
        return self._process_simple(pos1, pos2, length)

    def _trip_limit(self) -> None:
        """The search limit ran out (warn_for_search_limit,
        seed_search.c:551,3795): flag it, and warn through the caller's
        hook."""
        self.limit_exceeded = True
        if self.on_limit_exceeded is not None:
            self.on_limit_exceeded()

    def _report(self, pos1, pos2, length, s) -> int:
        got = self.reporter(pos1, pos2, length, s)
        if got > 0:
            self.search_to_go -= 1
        return got

    def _report_many(self, pos1, pos2, length, s) -> int:
        """`_report` of each row in turn (int arrays): through the
        reporter's bulk form `reporter.many` where it has one, which
        returns what each row's call would have, else one call a row."""
        many = getattr(self.reporter, "many", None)
        if many is not None:
            got = many(pos1, pos2, length, s)
        else:
            got = np.array([self.reporter(*row) for row in zip(
                pos1.tolist(), pos2.tolist(), length.tolist(), s.tolist())],
                dtype=np.int64)
        self.search_to_go -= int(np.count_nonzero(got > 0))
        return int(got.sum())

    def _process_plain(self, pos1, pos2, length) -> int:
        hp = self.hp
        if hp.pos_filter and self._filter_by_pos(pos1, pos2, length):
            return 0
        if hp.min_matches >= 0 and self._filter_by_subs(pos1, pos2, length):
            return 0
        return self._report(pos1, pos2, length, 0)

    def _process_simple(self, pos1, pos2, length) -> int:
        hp = self.hp
        if hp.pos_filter and self._filter_by_pos(pos1, pos2, length):
            return 0
        self._unblocked_left = False
        h = (pos1 - pos2) & (DIAG_HASH_SIZE - 1)
        de = self.diag_end
        if de[h] == HASH_INACTIVE:
            de[h] = 0
        if de[h] > pos2 - length:
            return 0
        if hp.min_matches >= 0 and self._filter_by_subs(pos1, pos2, length):
            return 0
        return self._extend_and_report(pos1, pos2, length, h)

    def _process_recover(self, pos1, pos2, length) -> int:
        """process_for_recoverable_hit (seed_search.c:1221-1420)."""
        hp = self.hp
        if hp.pos_filter and self._filter_by_pos(pos1, pos2, length):
            return 0
        start2 = pos2 - length
        diag = pos1 - pos2
        h = diag & (DIAG_HASH_SIZE - 1)
        de = self.diag_end
        self._unblocked_left = False
        if de[h] == HASH_INACTIVE:
            de[h] = 0
            self.diag_actual[h] = diag
        elif de[h] > start2:
            if self.diag_actual[h] == diag:
                return 0  # same true diagonal: genuine overlap, drop
            # hash collision with a different diagonal: accept, and allow
            # the left extension to run unblocked
            self._unblocked_left = True
        if hp.min_matches >= 0 and self._filter_by_subs(pos1, pos2, length):
            return 0
        return self._extend_and_report(pos1, pos2, length, h)

    SEED_HIT_QUEUE_SIZE = 256 * 1024

    def _ensure_twin_queue(self):
        if hasattr(self, "shq_pos2"):
            return
        n = self.SEED_HIT_QUEUE_SIZE
        self.shq_prev = np.zeros(n, dtype=np.int64)
        self.shq_isblock = np.zeros(n, dtype=bool)
        self.shq_pos2 = np.zeros(n, dtype=np.int64)
        self.shq_diag = np.zeros(n, dtype=np.int64)
        self.last_seed_hit = np.zeros(DIAG_HASH_SIZE, dtype=np.int64)
        self.seed_hit_num = n  # first hit gets number n+1

    def _enqueue_seed_hit(self, pos1, pos2, is_block):
        """reference _enqueue_seed_hit (diag_hash.c)."""
        n = self.SEED_HIT_QUEUE_SIZE
        diag = pos1 - pos2
        h = diag & (DIAG_HASH_SIZE - 1)
        self.seed_hit_num += 1
        ix = self.seed_hit_num % n
        if self.last_seed_hit[h] <= self.seed_hit_num - n:
            self.shq_prev[ix] = 0
        else:
            self.shq_prev[ix] = self.last_seed_hit[h]
        self.last_seed_hit[h] = self.seed_hit_num
        self.shq_isblock[ix] = is_block
        self.shq_pos2[ix] = pos2
        self.shq_diag[ix] = diag

    def _process_twin(self, pos1, pos2, length) -> int:
        """Queue-based twin-hit processing (the reference's default
        build: process_for_twin_hit with seedHitQueue,
        seed_search.c + diag_hash.h:106-145)."""
        hp = self.hp
        if hp.pos_filter and self._filter_by_pos(pos1, pos2, length):
            return 0
        if hp.min_matches >= 0 and self._filter_by_subs(pos1, pos2, length):
            return 0
        self._ensure_twin_queue()
        self._unblocked_left = False
        n = self.SEED_HIT_QUEUE_SIZE
        diag = pos1 - pos2
        h = diag & (DIAG_HASH_SIZE - 1)
        de = self.diag_end
        if de[h] == HASH_INACTIVE:
            de[h] = 0
            self._enqueue_seed_hit(pos1, pos2, False)
            return 0

        span = None
        num = int(self.last_seed_hit[h])
        found_twin = False
        while num > self.seed_hit_num - n:
            ix = num % n
            q_pos2 = int(self.shq_pos2[ix])
            span = pos2 - (q_pos2 - length)
            if span > self.twin_max_span:
                break
            if self.shq_diag[ix] != diag:
                num = int(self.shq_prev[ix])
                continue
            if self.shq_isblock[ix]:
                if pos2 - length <= q_pos2:
                    return 0  # overlaps a previous extension
                break
            if span < self.twin_min_span:
                num = int(self.shq_prev[ix])
                continue
            found_twin = True
            break
        if not found_twin:
            self._enqueue_seed_hit(pos1, pos2, False)
            return 0

        # twin found: the combined hit spans from the older hit's start
        length = span
        if hp.gf_extend == GFEX_XDROP:
            old_end = int(de[h])
            r = self._xdrop_extend(pos1, pos2, length)
            if de[h] != old_end:
                extent = int(de[h])
                self._enqueue_seed_hit(diag + extent, extent, True)
            if r is None:
                return 0
            pos1, pos2, length, s = r
        elif hp.gf_extend == GFEX_EXACT:
            old_end = int(de[h])
            r = self._match_extend(pos1, pos2, length)
            if de[h] != old_end:
                extent = int(de[h])
                self._enqueue_seed_hit(diag + extent, extent, True)
                if r is None:
                    self._enqueue_seed_hit(pos1, pos2, False)
            if r is None:
                return 0
            pos1, pos2, length, s = r
        else:
            de[h] = pos2
            s = 0
        return self._report(pos1, pos2, length, s)

    def _extend_and_report(self, pos1, pos2, length, h) -> int:
        hp = self.hp
        if hp.gf_extend == GFEX_XDROP:
            r = self._xdrop_extend(pos1, pos2, length)
            if r is None:
                return 0
            pos1, pos2, length, s = r
        elif hp.gf_extend == GFEX_EXACT:
            r = self._match_extend(pos1, pos2, length)
            if r is None:
                return 0
            pos1, pos2, length, s = r
        elif hp.gf_extend >= GFEX_MISMATCH_BASE:
            r = self._mismatch_extend(pos1, pos2, length)
            if r is None:
                return 0
            pos1, pos2, length, s = r
        else:  # no extension
            self.diag_end[h] = pos2
            s = 0
        return self._report(pos1, pos2, length, s)

    # -- gap-free extensions ------------------------------------------------

    def _xdrop_extend(self, pos1: int, pos2: int, length: int):
        """Exact reimplementation of xdrop_extend_seed_hit semantics."""
        hp = self.hp
        seq1, seq2 = self.seq1, self.seq2
        sub = self._sub
        x_drop = hp.x_drop
        diag = pos1 - pos2
        h = diag & (DIAG_HASH_SIZE - 1)

        old_diag_end = 0 if self._unblocked_left else int(self.diag_end[h])

        # --- left scan: from pos1 (just past hit end) down to stop
        block2 = old_diag_end
        stop1 = block2 + diag if block2 + diag > 0 else 0

        if self._native is not None:
            return self._xdrop_extend_native(pos1, pos2, length, diag, h,
                                             old_diag_end, stop1)
        n_left = pos1 - stop1
        if n_left > 0:
            sc = sub[seq1[stop1:pos1][::-1], seq2[stop1 - diag : pos2][::-1]]
            c = np.cumsum(sc)
            m = np.maximum.accumulate(c)
            run_ok = np.concatenate(([True], c >= np.maximum(m, 0) - x_drop))
            # number of consumed elements: first failure index
            fail = np.nonzero(~run_ok[:-1])[0]
            consumed = int(fail[0]) if len(fail) else n_left
            cc = c[:consumed]
            if len(cc):
                best = cc.max().item()
                if best > 0:
                    kstar = int(np.argmax(cc))
                    left_score = best
                    left_start = pos1 - 1 - kstar
                else:
                    left_score = 0
                    left_start = pos1
            else:
                left_score = 0
                left_start = pos1
        else:
            left_score = 0
            left_start = pos1

        # --- right scan: from pos1 to stop
        block2r = len(seq2)
        stop1r = len(seq1) if len(seq1) <= block2r + diag else block2r + diag
        n_right = stop1r - pos1
        if n_right > 0:
            sc = sub[seq1[pos1:stop1r], seq2[pos2 : pos2 + n_right]]
            c = np.cumsum(sc)
            m = np.maximum.accumulate(c)
            run_ok = np.concatenate(([True], c >= np.maximum(m, 0) - x_drop))
            fail = np.nonzero(~run_ok[:-1])[0]
            consumed = int(fail[0]) if len(fail) else n_right
            cc = c[:consumed]
            if len(cc):
                best = cc.max().item()
                if best > 0:
                    kstar = int(np.argmax(cc))
                    right_score = best
                    right_stop = pos1 + kstar + 1
                else:
                    right_score = 0
                    right_stop = pos1
            else:
                right_score = 0
                right_stop = pos1
            right_block = pos1 + consumed
        else:
            right_score = 0
            right_stop = pos1
            right_block = pos1

        similarity = left_score + right_score

        # record the extent reached on this hashed diagonal (always,
        # even if the HSP is discarded below)
        extent = right_block - diag
        if extent > self.diag_end[h]:
            self.diag_end[h] = extent
            self.diag_actual[h] = diag

        return hsp(self, similarity, right_stop, right_stop - diag,
                   right_stop - left_start)

    def _xdrop_extend_from(self, pos1, pos2, length, diag_end):
        """`_xdrop_extend` with the hashed diagonal's extent first set to
        `diag_end`: the scalar form of `_xdrop_extend_many`."""
        self.diag_end[(pos1 - pos2) & (DIAG_HASH_SIZE - 1)] = diag_end
        self._unblocked_left = False
        return self._xdrop_extend(pos1, pos2, length)

    def _xdrop_extend_many(self, pos1, pos2, diag_end):
        """The scans of `_xdrop_extend` for each hit in turn (int64
        arrays of end positions), its hashed diagonal's extent first
        set to `diag_end` (int64 array): one native call, then the
        extents recorded as the calls would leave them.  Returns
        (left_start, left_score, right_stop, right_score), before
        entropy and threshold.  Needs the native library."""
        lib, ctypes = self._native
        n = len(pos1)
        diag = pos1 - pos2
        stop1 = np.maximum(diag_end + diag, 0)
        stop1r = np.minimum(len(self.seq1), len(self.seq2) + diag)
        out = np.empty((5, n), dtype=np.int64)
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.xdrop_extend_many(
            self.seq1.ctypes.data_as(p_u8), self.seq2.ctypes.data_as(p_u8),
            self._sub.ctypes.data_as(p_i64), n,
            *(np.ascontiguousarray(a, dtype=np.int64).ctypes.data_as(p_i64)
              for a in (pos1, pos2, stop1, stop1r)),
            self.hp.x_drop, out.ctypes.data_as(p_i64))
        # each hit sets its hash to diag_end[i], then raises it to its
        # extent (and diag_actual to its diagonal): the last hit on a
        # hash leaves its extent, the last one that raised it its
        # diagonal
        h = diag & (DIAG_HASH_SIZE - 1)
        extent = out[4] - diag
        _, at = np.unique(h[::-1], return_index=True)
        last = n - 1 - at
        self.diag_end[h[last]] = np.maximum(diag_end[last], extent[last])
        up = np.flatnonzero(extent > diag_end)[::-1]
        _, at = np.unique(h[up], return_index=True)
        self.diag_actual[h[up[at]]] = diag[up[at]]
        self._unblocked_left = False
        return out[0], out[1], out[2], out[3]

    def _xdrop_extend_native(self, pos1, pos2, length, diag, h,
                             old_diag_end, stop1):
        """Native variant of the scans; identical semantics."""
        lib, ctypes = self._native
        hp = self.hp
        seq1, seq2 = self.seq1, self.seq2
        stop1r = min(len(seq1), len(seq2) + diag)
        i64 = ctypes.c_int64
        ls = i64()
        lsc = i64()
        rs = i64()
        rsc = i64()
        rb = i64()
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.xdrop_extend(
            seq1.ctypes.data_as(p_u8), seq2.ctypes.data_as(p_u8),
            self._sub.ctypes.data_as(p_i64),
            pos1, pos2, stop1, stop1r, hp.x_drop,
            ctypes.byref(ls), ctypes.byref(lsc),
            ctypes.byref(rs), ctypes.byref(rsc), ctypes.byref(rb))
        left_start, left_score = ls.value, lsc.value
        right_stop, right_score = rs.value, rsc.value
        right_block = rb.value

        similarity = left_score + right_score
        extent = right_block - diag
        if extent > self.diag_end[h]:
            self.diag_end[h] = extent
            self.diag_actual[h] = diag

        return hsp(self, similarity, right_stop, right_stop - diag,
                   right_stop - left_start)

    def _match_extend(self, pos1: int, pos2: int, length: int):
        """Exact-match extension (match_extend_seed_hit, seed_search.c):
        bases must match exactly (case-insensitive ACGT); the
        hspThreshold is interpreted as a minimum length."""
        from ..core.encoding import NUC_TO_BITS

        hp = self.hp
        seq1, seq2 = self.seq1, self.seq2
        diag = pos1 - pos2
        h = diag & (DIAG_HASH_SIZE - 1)
        c2b = NUC_TO_BITS

        # validate the hit body is an exact match (scanning from right)
        s1i, s2i = pos1, pos2
        stop = pos1 - length
        while s1i > stop:
            s1i -= 1
            s2i -= 1
            b1, b2 = c2b[seq1[s1i]], c2b[seq2[s2i]]
            if b1 != b2 or b1 < 0 or b2 < 0:
                extent = s2i
                if extent > self.diag_end[h]:
                    self.diag_end[h] = extent
                    self.diag_actual[h] = diag
                return None

        old_diag_end = 0 if self._unblocked_left else int(self.diag_end[h])
        block = old_diag_end + diag
        stop1 = block if block > 0 else 0
        # left extension: pre-decrement from the hit's start
        s1i = pos1 - length
        s2i = pos2 - length
        if s1i < stop1:
            s1i -= 1
            s2i -= 1
        else:
            while s1i >= stop1:
                if s1i == stop1:
                    s1i -= 1
                    s2i -= 1
                    break
                s1i -= 1
                s2i -= 1
                n1, n2 = seq1[s1i], seq2[s2i]
                b1, b2 = c2b[n1], c2b[n2]
                if n1 == 0 or n2 == 0 or b1 != b2 or b1 < 0 or b2 < 0:
                    break
        left = s1i

        # right extension: pre-increment from the hit's end; reaching
        # the stop reads the terminator in the reference, i.e. the scan
        # ends AT the stop position
        s1i = pos1 - 1
        s2i = pos2 - 1
        block2 = len(seq2)
        stop1r = len(seq1) if len(seq1) <= block2 + diag else block2 + diag
        broke = False
        while s1i + 1 < stop1r:
            s1i += 1
            s2i += 1
            n1, n2 = seq1[s1i], seq2[s2i]
            b1, b2 = c2b[n1], c2b[n2]
            if n1 == 0 or n2 == 0 or b1 != b2 or b1 < 0 or b2 < 0:
                broke = True
                break
        if not broke and s1i + 1 == stop1r:
            s1i += 1
            s2i += 1
        right = s1i

        extent = right - diag
        if extent > self.diag_end[h]:
            self.diag_end[h] = extent
            self.diag_actual[h] = diag

        new_pos1 = right
        new_pos2 = new_pos1 - diag
        new_len = right - (left + 1)
        if new_len < hp.hsp_threshold.s:
            return None
        return new_pos1, new_pos2, new_len, new_len

    def _mismatch_extend(self, pos1: int, pos2: int, length: int):
        """N-mismatch extension (mismatch_extend_seed_hit,
        seed_search.c): find the longest run with at most M mismatches
        covering the hit; threshold is a minimum length."""
        from ..core.encoding import NUC_TO_BITS
        from ..config import GFEX_MISMATCH_BASE

        hp = self.hp
        seq1, seq2 = self.seq1, self.seq2
        diag = pos1 - pos2
        h = diag & (DIAG_HASH_SIZE - 1)
        c2b = NUC_TO_BITS
        M = hp.gf_extend - GFEX_MISMATCH_BASE

        # count mismatches inside the hit (scanning right to left)
        E = 0
        extent = None
        s1i, s2i = pos1, pos2
        stop = pos1 - length
        while s1i > stop:
            s1i -= 1
            s2i -= 1
            b1, b2 = c2b[seq1[s1i]], c2b[seq2[s2i]]
            if b1 != b2 or b1 < 0 or b2 < 0:
                extent = s2i
                E += 1
                if E > M:
                    if extent is not None and extent > self.diag_end[h]:
                        self.diag_end[h] = extent
                        self.diag_actual[h] = diag
                    return None

        # left scan: collect up to M+1-E mismatch positions
        old_diag_end = 0 if self._unblocked_left else int(self.diag_end[h])
        block = old_diag_end + diag
        stop1 = block if block > 0 else 0
        want = M + 1 - E
        mm_loc: list[int] = []
        s1i = pos1 - length
        s2i = pos2 - length
        if s1i < stop1:
            s1i -= 1
            s2i -= 1
        else:
            while s1i >= stop1:
                if s1i == stop1:
                    s1i -= 1
                    s2i -= 1
                    break
                s1i -= 1
                s2i -= 1
                n1, n2 = seq1[s1i], seq2[s2i]
                b1, b2 = c2b[n1], c2b[n2]
                if n1 == 0 or n2 == 0:
                    break
                if b1 != b2 or b1 < 0 or b2 < 0:
                    mm_loc.insert(0, s1i)
                    if len(mm_loc) == want:
                        break
        if len(mm_loc) < want:
            mm_loc.insert(0, s1i)
        mm_shortfall = want - len(mm_loc)

        # right scan: pair each left start with an ending mismatch
        s1i = pos1 - 1
        s2i = pos2 - 1
        block2 = len(seq2)
        stop1r = len(seq1) if len(seq1) <= block2 + diag else block2 + diag
        best_len = 0
        left = right = None
        scan = 0
        broke = False
        while s1i + 1 < stop1r:
            s1i += 1
            s2i += 1
            n1, n2 = seq1[s1i], seq2[s2i]
            b1, b2 = c2b[n1], c2b[n2]
            if n1 == 0 or n2 == 0:
                broke = True
                break
            if b1 != b2 or b1 < 0 or b2 < 0:
                if extent is None:
                    extent = s2i
                if mm_shortfall > 0:
                    mm_shortfall -= 1
                    continue
                this_len = s1i - mm_loc[scan]
                if this_len > best_len:
                    best_len = this_len
                    left = mm_loc[scan]
                    right = s1i
                scan += 1
                if scan == len(mm_loc):
                    broke = True
                    break
        if not broke and s1i + 1 == stop1r:
            s1i += 1
            s2i += 1
        if scan < len(mm_loc):
            if extent is None:
                extent = s2i
            this_len = s1i - mm_loc[scan]
            if this_len > best_len:
                left = mm_loc[scan]
                right = s1i
        if left is None:
            raise RuntimeError("mismatch_extend found no interval")

        new_pos1 = right
        new_pos2 = new_pos1 - diag
        new_len = right - (left + 1)
        if new_len >= hp.hsp_threshold.s:
            extent = new_pos1 + 1 - diag
        if extent is not None and extent > self.diag_end[h]:
            self.diag_end[h] = extent
            self.diag_actual[h] = diag
        if new_len < hp.hsp_threshold.s:
            return None
        return new_pos1, new_pos2, new_len, new_len

    # -- filters -------------------------------------------------------------

    def _filter_by_pos(self, pos1, pos2, length) -> bool:
        ts, te = self.hp.target_interval
        qs, qe = self.hp.query_interval
        if ts or te:
            if pos1 - length < ts or pos1 > te:
                return True
        if qs or qe:
            if pos2 - length < qs or pos2 > qe:
                return True
        return False

    def _filter_by_subs(self, pos1, pos2, length) -> bool:
        """filter_seed_hit_by_subs (seed_search.c:2346+): reject hits
        with too few matches or too many transversions."""
        hp = self.hp
        c2b = self.char_to_bits
        b1 = c2b[self.seq1[pos1 - length : pos1]]
        b2 = c2b[self.seq2[pos2 - length : pos2]]
        care = np.ones(length, dtype=bool)
        if hp.filter_pattern is not None:
            pat = hp.filter_pattern
            care = np.frombuffer(pat.encode(), dtype=np.uint8) != ord("0")
        ok = (b1 >= 0) & (b2 >= 0) & care
        matches = int(np.count_nonzero(ok & (b1 == b2)))
        if matches < hp.min_matches:
            return True
        if hp.max_transversions >= 0:
            # transversion: low (pyrimidine) bits differ
            tv = int(np.count_nonzero(ok & ((b1 & 1) != (b2 & 1))))
            if tv > hp.max_transversions:
                return True
        return False
