"""Where the seed stage's survivors become HSPs.

A survivor is a seed hit that the 64K diagonal hash let through and
that was extended gap-free (xdrop_extend_seed_hit,
seed_search.c:2528-2960).  Its HSP spans the extension, with the
extension's score given the entropy factor (seed_search.c:2850-2905)
and then held against the score threshold.  `hsp` is that rule for one
survivor, as the engine's own extension ends; `Replay` applies it to
the batches of survivors that the device, batched and sharded tiers
hand over, reports the kept rows in order, and trips the search limit.

A bind row is a survivor whose left extension crossed the extent that
the hits before it left on its hashed diagonal: the engine extends it
again, that extent (`de_before`) first set on the hash.  The tiers'
other rows carry the extension's scores and ends.

A batch replays as arrays where no survivor reads state that another
one's report writes: an integer score threshold, no search limit,
integer scores, an extension, and the engine's native scans (which
redo every bind row in one call).  Else it replays one row at a time: a
coverage threshold reads the anchors table the reports fill, and a
search limit stops at the first row past the query position where it
ran out.

Counters: "replay candidates", "replay bulk candidates" (the rows of
the array replay), "replay bind re-extensions" and "replay entropy
rows" (rows of the array replay given the entropy factor).
"""

from __future__ import annotations

import numpy as np

from .. import stats as _stats
from ..config import GFEX_NO_EXTEND
from ..core import scoring as _scoring
from ..core.encoding import BITS_TO_NUC
from ..core.scoring import entropy, entropy_from_counts

# the bases of the array replay's entropy slices gathered at once
_ENTROPY_BLOCK = 1 << 22
# matched upper-case A, C, G, T -> 0..3, anything else -> 4
_NUC_CODE = np.full(256, 4, dtype=np.int64)
_NUC_CODE[np.frombuffer(BITS_TO_NUC, dtype=np.uint8)] = np.arange(4)


def _match_counts(seq1, seq2, end1, end2, length):
    """(rows, 4) counts of the matched upper-case A, C, G, T of
    seq1[end1 - length: end1] against seq2[end2 - length: end2], per
    row: one gather of every row's bases, one bincount over row ids."""
    m = length.shape[0]
    cum = np.cumsum(length)
    row = np.repeat(np.arange(m), length)
    k = np.arange(row.shape[0])
    a = seq1[k + (end1 - cum)[row]]
    b = seq2[k + (end2 - cum)[row]]
    code = _NUC_CODE[a]
    code[a != b] = 4
    return np.bincount(row * 5 + code, minlength=5 * m).reshape(m, 5)[:, :4]


def _entropies(seq1, seq2, end1, end2, length):
    """`entropy` of each row's slices (as _match_counts), float64: the
    counts in blocks of at most _ENTROPY_BLOCK bases (or one row), then
    core.scoring.entropy_from_counts once per distinct counts and
    length."""
    n = length.shape[0]
    cum = np.cumsum(length)
    q = []
    memo = {}
    lo = 0
    while lo < n:
        hi = max(lo + 1, int(np.searchsorted(
            cum, cum[lo] - length[lo] + _ENTROPY_BLOCK, "right")))
        counts = _match_counts(seq1, seq2, end1[lo:hi], end2[lo:hi],
                               length[lo:hi])
        for key in zip(*counts.T.tolist(), length[lo:hi].tolist()):
            v = memo.get(key)
            if v is None:
                v = memo[key] = entropy_from_counts(key[:4], key[4])
            q.append(v)
        lo = hi
    return np.array(q, dtype=np.float64)


def hsp(engine, similarity, pos1, pos2, length):
    """The HSP of one survivor whose extension ends at (pos1, pos2),
    `length` long, scoring `similarity` before entropy: (pos1, pos2,
    length, score), or None below the score threshold."""
    hp = engine.hp
    t = hp.hsp_threshold
    if hp.entropic_hsp:
        if t.t == "S":
            adjust = hp.hsp_zero_threshold <= similarity <= 3 * t.s
        else:
            anch = engine.anchors
            adjust = (similarity > 0 and anch is not None and len(anch) > 0
                      and similarity >= anch.low_score)
        if adjust:
            q = entropy(engine.seq1[pos1 - length: pos1],
                        engine.seq2[pos2 - length: pos2])
            similarity = (similarity * q if _scoring.SCORE_TYPE == "D"
                          else int(similarity * q))
    if t.t == "S" and similarity < t.s:
        return None
    return pos1, pos2, length, similarity


class Replay:
    """One search's replay of its survivors, batch by batch: the HSPs
    reported in order (or, under `defer`, kept until `flush`: the twin
    tier reports once its whole search has resolved), the bases they
    hit, and the search limit's trip."""

    def __init__(self, engine, defer: bool = False, restore: bool = False):
        self.engine = engine
        self.restore = restore
        self.st = _stats.current
        self.bases_hit = 0
        # the group (query position) at which the search limit ran out
        self.trip_pos = -1
        self.pending = [] if defer else None
        hp = engine.hp
        t = hp.hsp_threshold
        self.extend = hp.gf_extend != GFEX_NO_EXTEND
        self.bulk = (t.t == "S" and int(t.s) == t.s and self.extend
                     and engine.search_limit <= 0
                     and _scoring.SCORE_TYPE != "D"
                     and engine._native is not None)

    def rows(self, pos1, pos2, grp, lscore, lstart, rscore, rstop,
             de_before, bind) -> bool:
        """Replay one batch of survivors, in report order: int64 arrays
        of the hits' end positions, their groups, the extension's left
        score and start and right score and stop, and the hashed
        diagonal's extent before each row; `bind` marks the bind rows
        (bool).  The score arrays may be overwritten.  Without an
        extension each hit is reported as it is.  Under `restore` the
        diagonal state at the bind rows' hashes is put back after the
        batch: the host tiers' chunk-final state already holds every
        surviving hit's extent (the right scan does not depend on the
        left block), which their re-extensions would otherwise lower.
        False when the search limit stopped the search."""
        if not self.restore:
            return self._rows(pos1, pos2, grp, lscore, lstart, rscore,
                              rstop, de_before, bind)
        de, da = self.engine.diag_end, self.engine.diag_actual
        touched = (pos1[bind] - pos2[bind]) & (len(de) - 1)
        saved = de[touched], da[touched]
        ok = self._rows(pos1, pos2, grp, lscore, lstart, rscore, rstop,
                        de_before, bind)
        de[touched], da[touched] = saved
        return ok

    def _rows(self, pos1, pos2, grp, lscore, lstart, rscore, rstop,
              de_before, bind) -> bool:
        st = self.st
        n = len(pos1)
        st.add("replay candidates", n)
        st.add("replay bind re-extensions", int(np.count_nonzero(bind)))
        st.add("replay bulk candidates", n if self.bulk else 0)
        if self.bulk:
            self._arrays(pos1, pos2, grp, lscore, lstart, rscore, rstop,
                         de_before, np.flatnonzero(bind))
            return True
        engine = self.engine
        L = engine.seed.length
        for p1, p2, g, ls, lst, rs, rst, deb, b in zip(
                *(a.tolist() for a in (pos1, pos2, grp, lscore, lstart,
                                       rscore, rstop, de_before, bind))):
            if self._past_trip(g):
                return False
            if not self.extend:
                r = (p1, p2, L, 0)
            elif b:
                r = engine._xdrop_extend_from(p1, p2, L, deb)
            else:
                r = hsp(engine, ls + rs, rst, rst - (p1 - p2), rst - lst)
            if r is not None:
                self._emit(g, r)
        return True

    def _arrays(self, pos1, pos2, grp, lscore, lstart, rscore, rstop,
                de_before, bind):
        """`rows` as arrays: the bind rows' scans redone at once, then
        each row's score, entropy and threshold as `hsp` computes them,
        and one report of the kept rows in order."""
        engine = self.engine
        hp = engine.hp
        thresh = hp.hsp_threshold.s
        if bind.size:
            redone = engine._xdrop_extend_many(pos1[bind], pos2[bind],
                                               de_before[bind])
            for col, v in zip((lstart, lscore, rstop, rscore), redone):
                col[bind] = v
        similarity = lscore + rscore
        new_pos1 = rstop
        new_pos2 = new_pos1 - (pos1 - pos2)
        new_length = new_pos1 - lstart
        if hp.entropic_hsp:
            adj = np.flatnonzero((similarity >= hp.hsp_zero_threshold)
                                 & (similarity <= 3 * thresh))
            if adj.size:
                self.st.add("replay entropy rows", int(adj.size))
                q = _entropies(engine.seq1, engine.seq2, new_pos1[adj],
                               new_pos2[adj], new_length[adj])
                # int(similarity * q): a float product, truncated
                similarity[adj] = (similarity[adj] * q).astype(np.int64)
        keep = np.flatnonzero(similarity >= thresh)
        if not keep.size:
            return
        kept = (new_pos1[keep], new_pos2[keep], new_length[keep],
                similarity[keep])
        if self.pending is not None:
            self.pending.extend(zip(grp[keep].tolist(),
                                    *(a.tolist() for a in kept)))
        else:
            self.bases_hit += engine._report_many(*kept)
            self.st.hsps += int(keep.size)

    def _past_trip(self, g) -> bool:
        """Whether group `g` lies past the query position where the
        search limit ran out; then the limit trips."""
        if self.pending is None and 0 <= self.trip_pos < g:
            self.engine._trip_limit()
            return True
        return False

    def _emit(self, g, r):
        """Report the HSP `r` of group `g` (or keep it, deferred), and
        note the group where the search limit runs out."""
        if self.pending is not None:
            self.pending.append((g, *r))
            return
        engine = self.engine
        self.bases_hit += engine._report(*r)
        if self.extend:
            self.st.hsps += 1
        if (engine.search_limit > 0 and engine.search_to_go < 0
                and self.trip_pos < 0):
            self.trip_pos = g

    def report(self, rows) -> bool:
        """Report HSP rows (group, pos1, pos2, length, score) in order;
        False when the search limit stopped them."""
        for g, *r in rows:
            if self._past_trip(g):
                return False
            self._emit(g, r)
        return True

    def flush(self) -> bool:
        """Report the deferred rows in order (as `report`)."""
        rows, self.pending = self.pending, None
        return self.report(rows)

    def stop(self, more: bool = True) -> bool:
        """Trip the search limit if it ran out and `more` of the search
        is left; True when it did."""
        if self.trip_pos >= 0 and more:
            self.engine._trip_limit()
            return True
        return False
