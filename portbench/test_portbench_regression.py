"""What the per-configuration judge and the record-level traffic key
must leave as it was: the LAV judge, chosen by configurations that name
no `check`, gives the numbers and facts it gave before on a fixed set
of records, and the existing traffic mixes draw the same bytes. The
expected values were read from the harness as it stood before either
change, on the same seeds."""

import copy
import hashlib
import tempfile

import pytest

from portbench.bench import ROOT, Cell, Run, load_json
from portbench.cellrun import check
from portbench.genome import WARM_KEY, GenomeModel
from portbench.reference import check as lav_judge

SMALL_GENOME = {"target_bp": 150_000, "families": 20}
SMALL_TRAFFIC = {"record_bp": [8_000, 12_000], "block_bp": [400, 2_000]}
FACTS = ("alignments", "sampled_alignments", "reference_hsps",
         "program_anchors")
# (cell, fault): (the judge's NUMBERS in order, FACTS in order), on the
# first four records of seed 2**31 + 11 (mammal) or + 12 (primate)
LAV_EXPECTED = {
    ("ucsc_mammal.ortholog", None):
        ((0, 0, 0, 0, 0.0, 0.0, 0.0, 0.0), (9, 9, 72, 72)),
    ("ucsc_mammal.ortholog", "control_int16"):
        ((0, 6, 0, 0, 66.66666666666667, 0.0, 0.0, 38.888888888888886),
         (9, 9, 72, 72)),
    ("ucsc_mammal.ortholog", "half_dropped"):
        ((0, 0, 0, 0, 0.0, 48.611111111111114, 0.0, 26.38888888888889),
         (6, 6, 72, 37)),
    ("ucsc_mammal.ortholog", "altered"):
        ((0, 3, 0, 0, 0.0, 48.611111111111114, 43.05555555555556, 0.0),
         (9, 9, 72, 72)),
    ("ucsc_mammal.ortholog", "unfiltered"):
        ((0, 0, 3, 3, 25.0, 0.0, 0.0, 0.0), (12, 12, 72, 72)),
    ("ucsc_primate.ortholog", None):
        ((0, 0, 0, 0, 0.0, 0.0, 0.0, 0.0), (8, 8, 60, 60)),
    ("ucsc_primate.ortholog", "control_int16"):
        ((0, 8, 0, 0, 100.0, 0.0, 0.0, 88.33333333333333), (8, 8, 60, 60)),
    ("ucsc_primate.ortholog", "half_dropped"):
        ((0, 0, 0, 0, 0.0, 48.333333333333336, 0.0, 65.0), (4, 4, 60, 31)),
    ("ucsc_primate.ortholog", "altered"):
        ((0, 4, 0, 0, 0.0, 48.333333333333336, 46.666666666666664, 0.0),
         (8, 8, 60, 60)),
    ("ucsc_primate.ortholog", "unfiltered"):
        ((0, 0, 4, 4, 33.333333333333336, 0.0, 0.0, 0.0), (12, 12, 60, 60)),
}
SEEDS = {"ucsc_mammal.ortholog": 2**31 + 11,
         "ucsc_primate.ortholog": 2**31 + 12}
# sha256 (first 16 hex digits) of the target, and of records 0, 3 and
# 11 and the warm-up record of each mix, at these seeds
DIGESTS = {
    7: {"target": "5d6b87c6452c51ca", "ortholog_blocks": "57328a4f2fe99c59",
        "collinear_chimp": "179e31d2919ee192",
        "background": "188f5c97ebb5f891"},
    2**31 + 7: {"target": "52b2d27a91ad7984",
                "ortholog_blocks": "b6845fe983e0d375",
                "collinear_chimp": "9e4861273a17a3f2",
                "background": "44c574e345cac71e"},
    4_400_000_123: {"target": "4e0d1a43c73a345d",
                    "ortholog_blocks": "9de755d1db0aca92",
                    "collinear_chimp": "6df5e8124d248700",
                    "background": "ba29b9a15b747d55"},
}


@pytest.fixture(scope="module")
def windows():
    """Each ortholog cell's first four records as the port gives them on
    the CPU, its gapped stage's geometry shrunk."""
    import torch
    import lastz_tpu_torch.align.ydrop_device as yd
    mp = pytest.MonkeyPatch()
    mp.setenv("LASTZ_TORCH_DEVICE", "cpu")
    mp.setattr(yd, "DEFAULT_WIDTH", 128)
    mp.setattr(yd, "DEFAULT_ROWS", 64)
    mp.setattr(yd, "DEFAULT_BATCH", 16)
    out = {}
    try:
        for name, seed in SEEDS.items():
            with tempfile.TemporaryDirectory() as tmp:
                run = Run(Cell(name), seed, torch.device("cpu"), tmp,
                          SMALL_GENOME, SMALL_TRAFFIC)
                run.setup()
                recs, _ = run.drive(run.source,
                                    lambda f: len(f.records) >= 4)
            out[name] = (run, recs)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("cell, fault", list(LAV_EXPECTED),
                         ids=lambda v: str(v))
def test_lav_judge_reads_as_before(windows, cell, fault):
    c = Cell(cell)
    assert c.check_name == "check" and c.judge() is lav_judge
    run, recs = windows[cell]
    numbers, facts = check(c, run, copy.deepcopy(recs), fault)
    want_n, want_f = LAV_EXPECTED[(cell, fault)]
    assert tuple(numbers[k] for k in lav_judge.NUMBERS) == want_n
    assert tuple(facts[k] for k in FACTS) == want_f


@pytest.mark.parametrize("seed", list(DIGESTS))
def test_existing_traffic_draws_the_same_bytes(seed):
    genome = dict(Cell("ucsc_mammal.ortholog").config["genome"],
                  target_bp=400_000, families=40)
    model = GenomeModel(seed, genome)
    got = {"target": hashlib.sha256(model.target.tobytes()).hexdigest()[:16]}
    for mix in ("ortholog_blocks", "collinear_chimp", "background"):
        tr = load_json(ROOT, "portbench", "traffic", mix + ".json")
        d = hashlib.sha256()
        for i in (0, 3, 11):
            name, seq, _ = model.record(tr, i)
            d.update(name.encode())
            d.update(seq.tobytes())
        d.update(model.record(tr, 0, length=60_000, key=WARM_KEY)[1]
                 .tobytes())
        got[mix] = d.hexdigest()[:16]
    assert got == DIGESTS[seed]
