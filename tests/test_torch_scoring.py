"""The port's entropy pieces (lastz_tpu_torch/core/scoring.py,
search/device_hits.py) against lastz_tpu's entropy: the shared scalar
formula on a slice pair's counts is entropy to the bit, and the seed
stage's vectorised counts are count_nonzero per slice."""

import numpy as np
import pytest

from lastz_tpu.core.scoring import entropy
import torch_threads  # noqa: F401  (a share of the cores per xdist worker)


def _slice_pairs(kind, rng):
    """(s, t) slice pairs of lengths 1 to 2,000: random ACGT at 70% to
    100% identity, near-identical pairs of fewer than 20 matches, or
    an alphabet with lower case, N and IUPAC codes."""
    alpha = {"random": b"ACGT", "few_matches": b"ACGT",
             "lower_n": b"ACGTacgtNNRY"}[kind]
    alpha = np.frombuffer(alpha, dtype=np.uint8)
    lengths = [1, 2, 19, 20, 21, 57, 400, 2000] + list(
        rng.integers(1, 2001, 40))
    for n in lengths:
        s = alpha[rng.integers(0, len(alpha), n)]
        t = s.copy()
        if kind == "few_matches":
            keep = rng.random(n) < min(1.0, 19.0 / n)
            t[~keep] = alpha[(np.searchsorted(alpha, s[~keep]) + 1) % 4]
        else:
            mut = rng.random(n) < rng.uniform(0.0, 0.3)
            t[mut] = alpha[rng.integers(0, len(alpha), int(mut.sum()))]
        yield s, t


@pytest.mark.parametrize("kind", ["random", "few_matches", "lower_n"])
def test_entropy_from_counts_equals_entropy(kind):
    """The port's entropy_from_counts, on a slice pair's counts of
    matched upper-case A, C, G, T, is entropy of the pair to the bit,
    and both equal lastz_tpu's entropy."""
    from lastz_tpu_torch.core import scoring as tscoring
    rng = np.random.default_rng(["random", "few_matches",
                                 "lower_n"].index(kind) + 40)
    seen_one = 0
    for s, t in _slice_pairs(kind, rng):
        eq = s == t
        counts = [int(np.count_nonzero(eq & (s == ch))) for ch in b"ACGT"]
        got = tscoring.entropy_from_counts(counts, len(s))
        want = tscoring.entropy(s, t)
        assert got.hex() == float(want).hex(), (len(s), counts)
        assert want == entropy(s, t)
        seen_one += got == 1.0
    assert seen_one > 0


def test_match_counts_equal_count_nonzero():
    """The seed stage's vectorised counts (one gather, one bincount)
    equal count_nonzero over each slice, lower case and N included."""
    from lastz_tpu_torch.search.replay import _match_counts
    rng = np.random.default_rng(7)
    alpha = np.frombuffer(b"ACGTacgtNNRY", dtype=np.uint8)
    seq1 = alpha[rng.integers(0, len(alpha), 5000)]
    seq2 = seq1.copy()
    mut = rng.random(5000) < 0.2
    seq2[mut] = alpha[rng.integers(0, len(alpha), int(mut.sum()))]
    length = np.concatenate([[0, 1, 2000], rng.integers(0, 400, 60)])
    end1 = np.array([rng.integers(n, 5001) for n in length])
    end2 = np.array([rng.integers(n, 5001) for n in length])
    got = _match_counts(seq1, seq2, end1, end2, length)
    for i, n in enumerate(length):
        s = seq1[end1[i] - n: end1[i]]
        t = seq2[end2[i] - n: end2[i]]
        assert got[i].tolist() == [
            int(np.count_nonzero((s == t) & (s == ch))) for ch in b"ACGT"]
