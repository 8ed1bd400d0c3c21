"""The genome model: the same seed gives the same bytes, and the stated
shares and ranges hold."""

import numpy as np
import pytest

from portbench.bench import ROOT, Cell, load_json
from portbench.genome import CODE, GenomeModel, reverse_complement

GENOME = dict(Cell("ucsc_mammal.ortholog").config["genome"],
              target_bp=400_000, families=40)


@pytest.fixture(scope="module")
def model():
    return GenomeModel(2**31 + 7, GENOME)


def test_deterministic(model):
    other = GenomeModel(2**31 + 7, GENOME)
    assert np.array_equal(model.target, other.target)
    tr = Cell("ucsc_mammal.ortholog").traffic
    a = model.record(tr, 3)
    b = other.record(tr, 3)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    assert not np.array_equal(GenomeModel(5, GENOME).target, model.target)


def test_target_composition(model):
    t = model.target
    assert len(t) == GENOME["target_bp"]
    assert abs(np.mean(t >= 97) - GENOME["masked_share"]) < 0.08
    gc = np.isin(t, np.frombuffer(b"GCgc", np.uint8)).mean()
    assert abs(gc - GENOME["gc"]) < 0.02
    assert (CODE[t] < 4).all()


@pytest.mark.parametrize("mix", ["ortholog_blocks", "collinear_chimp",
                                 "background"])
def test_records(model, mix):
    tr = load_json(ROOT, "portbench", "traffic", mix + ".json")
    lo, hi = tr["record_bp"]
    got = [model.record(tr, i, length=20_000) for i in range(12)]
    lengths = [model.record(tr, i)[2]["length"] for i in range(30)]
    slack = 1.1 if tr["insert_share"] else 1.05
    assert lo * 0.95 <= min(lengths) and max(lengths) <= hi * slack
    share = np.mean([f["ortholog_bp"] / f["length"] for _, _, f in got])
    assert abs(share - tr["ortholog_share"]) < 0.12
    if tr["ortholog_share"] > 0:
        for name, seq, f in got:
            for start, n, ident in f["blocks"]:
                assert tr["identity"][0] <= ident <= tr["identity"][1]
    rev = np.mean([f["reverse"] for _, _, f in got])
    assert 0 < rev < 1


def test_block_identity(model):
    """A block copied at identity p differs from its source at about
    1 - p of its bases (substitutions only, no indels)."""
    tr = dict(Cell("ucsc_primate.ortholog").traffic, indel_rate=0.0,
              insert_share=0.0, reverse_share=0.0, identity=[0.9, 0.9])
    name, seq, f = model.record(tr, 1, length=50_000)
    start, n, _ = f["blocks"][0]
    src = model.target[start:start + n]
    diff = np.mean(CODE[src] != CODE[seq])
    assert abs(diff - 0.1) < 0.01
    assert np.array_equal(reverse_complement(reverse_complement(seq)), seq)


def test_same_sizes_every_seed(model):
    """Each run of `strata` records holds the same sizes for any seed."""
    tr = Cell("ucsc_mammal.ortholog").traffic
    other = GenomeModel(99, GENOME)
    k = tr["strata"]
    for block in range(3):
        a = [model.record_length(tr, block * k + i) for i in range(k)]
        b = [other.record_length(tr, block * k + i) for i in range(k)]
        assert sorted(a) == sorted(b) and a != b


READS = {"record_bp": [101, 101], "strata": 1, "ortholog_share": 1.0,
         "block_bp": None, "identity": [0.97, 0.995],
         "transition_share": 0.6667, "indel_rate": 0.002, "indel_mean": 1,
         "indel_max": 3, "insert_share": 0.0, "reverse_share": 0.5}


def test_unrelated_share(model):
    """`unrelated_share` makes that share of whole records unrelated;
    at 0 every record is what it is without the key."""
    tr = dict(READS, unrelated_share=0.25)
    facts = [model.record(tr, i)[2] for i in range(400)]
    junk = np.mean([f["ortholog_bp"] == 0 for f in facts])
    assert abs(junk - 0.25) < 0.06
    assert all(f["ortholog_bp"] == 0 or f["blocks"] for f in facts)
    for i in range(20):
        a = model.record(READS, i)
        b = model.record(dict(READS, unrelated_share=0.0), i)
        assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_pool_of_short_reads_is_bounded(model):
    from portbench.bench import POOL_BP, POOL_RECORDS, make_pool
    pool = make_pool(model, dict(READS, unrelated_share=0.1), POOL_BP)
    assert len(pool) == POOL_RECORDS
    assert pool[7][0] == model.record(dict(READS, unrelated_share=0.1),
                                      7)[0]
    # a traffic of long records stops at its bases, as before
    tr = Cell("ucsc_mammal.ortholog").traffic
    long = make_pool(model, tr, 1_000_000)
    assert sum(len(s) for _, s in long[:-1]) < 1_000_000 <= sum(
        len(s) for _, s in long)
