"""Seeded genome model: a soft-masked target chunk and query records.

One general generator for every configuration and traffic mix. The
configuration's "genome" group fixes the target (length, GC share,
repeat families and the share of the target they cover, lowercase);
a traffic mix's parameters fix the query records (lengths, the same
set of sizes for every seed in another order; the share
of each record that is orthologous to the target, in blocks or as one
collinear copy, its identity, indels and lineage-specific insertions,
orientation; optionally `unrelated_share`, the share of whole records
with no orthology at all). Everything is drawn from (seed, key) with
numpy in a few vectorised calls, so the same seed gives the same bytes.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# ASCII -> 0..3 for ACGT in either case, 255 otherwise
CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
    CODE[_c + 32] = _i
# ASCII complement, case kept
COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in (b"AT", b"TA", b"CG", b"GC"):
    COMPLEMENT[_a] = _b
    COMPLEMENT[_a + 32] = _b + 32

RECORD_KEY = 1
WARM_KEY = 2
TARGET_KEY = 3
STRATA_KEY = 4


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A generator drawn from the run's seed and a key path."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) % (1 << 64), *keys])))


def random_bases(rng, n: int, gc: float) -> np.ndarray:
    """n uppercase ASCII bases with the given GC share."""
    at = (1.0 - gc) / 2
    r = rng.random(n, dtype=np.float32)
    code = ((r >= at).astype(np.uint8) + (r >= at + gc / 2)
            + (r >= at + gc))
    return ACGT[code]


def log_uniform(rng, lo, hi, size=None):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), size)).astype(np.int64)


def substitute(rng, seq: np.ndarray, rate: np.ndarray | float,
               transition_share: float) -> np.ndarray:
    """Substitutions at `rate` per base (a scalar or one rate a base),
    transitions at `transition_share` of them; case is kept."""
    out = seq.copy()
    hit = rng.random(len(seq)) < rate
    idx = np.nonzero(hit & (CODE[seq] < 4))[0]
    code = CODE[seq[idx]].astype(np.int64)
    ts = rng.random(len(idx)) < transition_share
    # A<->G and C<->T are code ^ 2; the two transversions are code ^ 1
    # and code ^ 3
    new = np.where(ts, code ^ 2, code ^ np.where(rng.random(len(idx)) < 0.5,
                                                 1, 3))
    lower = seq[idx] >= 97
    out[idx] = ACGT[new] + np.where(lower, 32, 0).astype(np.uint8)
    return out


def indels(rng, seq: np.ndarray, rate: float, mean: float, top: int,
           gc: float) -> np.ndarray:
    """Insertions and deletions, each half of `rate` events a base, of
    geometric lengths with the given mean, cut at `top`."""
    n = len(seq)
    if rate <= 0 or n == 0:
        return seq
    k = rng.binomial(n, rate)
    if k == 0:
        # the draws below would be of size 0, which leave the stream as
        # it is: a short record is spared their cost
        return seq
    pos = np.sort(rng.integers(0, n, k))
    length = np.minimum(rng.geometric(1.0 / mean, k), top)
    is_ins = rng.random(k) < 0.5
    keep = np.ones(n, dtype=bool)
    d_pos, d_len = pos[~is_ins], length[~is_ins]
    if len(d_pos):
        starts = np.repeat(d_pos, d_len)
        offs = np.arange(len(starts)) - np.repeat(
            np.cumsum(d_len) - d_len, d_len)
        drop = starts + offs
        keep[drop[drop < n]] = False
    i_pos, i_len = pos[is_ins], length[is_ins]
    at = np.repeat(i_pos, i_len)
    bases = random_bases(rng, len(at), gc)
    out = np.insert(seq, at, bases)
    mask = np.insert(keep, at, True)
    return out[mask]


class RepeatLibrary:
    """Repeat-family consensus sequences; copies of them, diverged and
    in lowercase, make up the soft-masked share of the model genome."""

    def __init__(self, rng, families: int, length, gc: float):
        lens = log_uniform(rng, length[0], length[1], families)
        self.lens = lens
        self.starts = np.cumsum(lens) - lens
        self.bases = random_bases(rng, int(lens.sum()), gc)

    def copies(self, rng, k: int, divergence, transition_share: float):
        """k 5'-truncated copies of random families: (lengths, bases)."""
        fam = rng.integers(0, len(self.lens), k)
        flen = self.lens[fam]
        cut = (rng.random(k) * flen / 2).astype(np.int64)
        clen = flen - cut
        src0 = self.starts[fam] + cut
        idx = np.repeat(src0, clen) + (
            np.arange(int(clen.sum())) - np.repeat(np.cumsum(clen) - clen,
                                                   clen))
        rate = np.repeat(rng.uniform(divergence[0], divergence[1], k), clen)
        bases = substitute(rng, self.bases[idx], rate, transition_share)
        return clen, bases + np.uint8(32)


def genomic(rng, n: int, lib: RepeatLibrary, g: dict) -> np.ndarray:
    """n bases of model genome: random sequence at the configuration's
    GC share with lowercase repeat copies covering `masked_share`."""
    if n <= 0:
        return np.zeros(0, dtype=np.uint8)
    share = g["masked_share"]
    mean_copy = float(np.mean(lib.lens)) * 0.75
    k = int(n / mean_copy * share * 1.3) + 4
    clen, cbases = lib.copies(rng, k, g["repeat_divergence"],
                              g["transition_share"])
    gap_mean = mean_copy * (1.0 - share) / share
    gaps = rng.exponential(gap_mean, k).astype(np.int64)
    # lay out gap, copy, gap, copy ... and cut at n
    seg = np.empty(2 * k, dtype=np.int64)
    seg[0::2] = gaps
    seg[1::2] = clen
    ends = np.cumsum(seg)
    out = random_bases(rng, n, g["gc"])
    copy_starts = ends[1::2] - clen
    dst = np.repeat(copy_starts, clen) + (
        np.arange(int(clen.sum())) - np.repeat(np.cumsum(clen) - clen, clen))
    inside = dst < n
    out[dst[inside]] = cbases[inside]
    return out


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    return COMPLEMENT[seq[::-1]]


class GenomeModel:
    """The target chunk and the query records of one run."""

    def __init__(self, seed: int, genome: dict):
        self.seed = seed
        self.g = genome
        rng = rng_for(seed, TARGET_KEY)
        self.lib = RepeatLibrary(rng, genome["families"],
                                 genome["family_bp"], genome["gc"])
        self.target = genomic(rng, genome["target_bp"], self.lib, genome)

    def record(self, traffic: dict, index: int, length: int | None = None,
               key: int = RECORD_KEY):
        """Query record `index` of the stream: (name, bases, facts),
        where facts holds what the generator put in it."""
        rng = rng_for(self.seed, key, index)
        n = int(length if length is not None
                else self.record_length(traffic, index))
        share = traffic["ortholog_share"]
        # a share of whole records with no orthology (a read set's junk
        # reads), decided by the record's own stream; absent or 0, no
        # draw is made and every record is what it was without the key
        unrelated = traffic.get("unrelated_share", 0)
        if unrelated > 0 and rng.random() < unrelated:
            share = 0
        g = self.g
        tlen = len(self.target)
        facts = {"length": n, "ortholog_bp": 0, "blocks": []}
        if share <= 0:
            seq = genomic(rng, n, self.lib, g)
        else:
            if traffic["block_bp"] is None:
                blens = np.array([n], dtype=np.int64)
            else:
                want = share * n
                blens = log_uniform(rng, *traffic["block_bp"],
                                    int(want / traffic["block_bp"][0]) + 2)
                blens = blens[:int(np.searchsorted(np.cumsum(blens), want)) + 1]
                # the last block ends where the share is reached
                rest = int(want - blens[:-1].sum())
                if rest >= traffic["block_bp"][0] or len(blens) == 1:
                    blens[-1] = max(rest, 1)
                else:
                    blens = blens[:-1]
            nb = len(blens)
            filler = max(n - int(blens.sum()), 0) if nb > 1 or share < 1 \
                else 0
            w = rng.exponential(1.0, nb + 1)
            fill = (filler * w / w.sum()).astype(np.int64)
            tgap = rng.exponential(max(filler / max(nb, 1), 1.0),
                                   nb).astype(np.int64)
            tgap[0] = 0
            span = int(blens.sum() + tgap.sum())
            t0 = int(rng.integers(0, max(tlen - span, 1)))
            tstart = t0 + np.cumsum(tgap + np.concatenate(([0], blens[:-1])))
            parts = []
            ident = rng.uniform(*traffic["identity"], nb)
            for b in range(nb):
                parts.append(genomic(rng, int(fill[b]), self.lib, g))
                src = self.target[tstart[b]:tstart[b] + blens[b]]
                mut = substitute(rng, src, 1.0 - ident[b],
                                 traffic["transition_share"])
                mut = indels(rng, mut, traffic["indel_rate"],
                             traffic["indel_mean"], traffic["indel_max"],
                             g["gc"])
                facts["blocks"].append((int(tstart[b]), int(blens[b]),
                                        float(ident[b])))
                facts["ortholog_bp"] += int(blens[b])
                parts.append(mut)
            parts.append(genomic(rng, int(fill[nb]), self.lib, g))
            seq = np.concatenate(parts)
            ins = traffic["insert_share"]
            if ins > 0:
                seq = self._insertions(rng, seq, ins)
        facts["reverse"] = bool(rng.random() < traffic["reverse_share"])
        if facts["reverse"]:
            seq = reverse_complement(seq)
        facts["length"] = len(seq)
        return f"q{key}_{index}", seq, facts

    def record_length(self, traffic: dict, index: int) -> int:
        """Every seed streams the same sizes in another order: each run of
        `strata` records holds one record of each stratum of the
        log-uniform range (its middle), in an order drawn from the seed."""
        lo, hi = traffic["record_bp"]
        k = traffic["strata"]
        # a single stratum has no order to draw
        d = 0 if k == 1 else rng_for(self.seed, STRATA_KEY,
                                     index // k).permutation(k)[index % k]
        return int(np.exp(np.log(lo) + (d + 0.5) / k * np.log(hi / lo)))

    def _insertions(self, rng, seq, share):
        """Lineage-specific insertions: repeat copies (lowercase) at
        random points, `share` of the record's bases in all."""
        want = share * len(seq)
        k = int(want / (float(np.mean(self.lib.lens)) * 0.75)) + 1
        clen, cb = self.lib.copies(rng, k, self.g["repeat_divergence"],
                                   self.g["transition_share"])
        take = int(np.searchsorted(np.cumsum(clen), want)) + 1
        clen, cb = clen[:take], cb[:int(clen[:take].sum())]
        at = np.repeat(np.sort(rng.integers(0, len(seq), len(clen))), clen)
        return np.insert(seq, at, cb)


def fasta(name: str, seq: np.ndarray, width: int = 80) -> bytes:
    """One FASTA record, `width` bases a line."""
    full = len(seq) - len(seq) % width
    rows = np.concatenate([seq[:full].reshape(-1, width),
                           np.full((full // width, 1), 10, np.uint8)], axis=1)
    tail = seq[full:].tobytes() + (b"\n" if full < len(seq) else b"")
    return b">" + name.encode() + b"\n" + rows.tobytes() + tail
