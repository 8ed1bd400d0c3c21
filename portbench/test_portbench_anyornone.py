"""The any-or-none SAM judge on the port's own output: a configuration
that names `"check": "anyornone"`, in a checkout of its own made here,
runs Any-or-None read mapping (`--format=softsam`) on the CPU through
the whole harness. Its sound output reads 0 on every count and `missed`
at or under 1%; the control and each planted fault read above the
limits."""

import copy
import io
import json
import os
import subprocess
import sys
import time

import pytest

from portbench.bench import ROOT, Cell
from portbench.cellrun import FORBIDDEN, check, execute, measure

SEED = 2**31 + 101
ANYORNONE = ["--anyornone", "--step=10", "--seed=match12", "--notransition",
             "--exact=20", "--noytrim", "--match=1,5", "--ambiguous=n",
             "--filter=coverage:90", "--filter=identity:95",
             "--format=softsam"]
CONFIG = {
    "source": "LASTZ README, Any-or-None Alignment",
    "check": "anyornone",
    "options": ANYORNONE,
    "scores_file": "match_1_5.q",
    "reference": {"seed_pattern": "111111111111", "step": 10,
                  "transitions": False, "exact": 20, "gap_open": 17,
                  "gap_extend": 2, "y_drop": 46, "gapped_threshold": 30,
                  "min_identity": 0.95, "min_coverage": 0.90},
    "genome": {"target_bp": 1_000_000, "gc": 0.41, "masked_share": 0.5,
               "families": 40, "family_bp": [300, 6000],
               "repeat_divergence": [0.1, 0.2], "transition_share": 0.6667},
}
READS = {"record_bp": [101, 101], "strata": 1, "ortholog_share": 1.0,
         "block_bp": None, "identity": [0.97, 0.995],
         "transition_share": 0.6667, "indel_rate": 0.002, "indel_mean": 1,
         "indel_max": 3, "insert_share": 0.0, "reverse_share": 0.5,
         "unrelated_share": 0.1}
LIMITS = {"sam_unreadable": 0, "multiple": 0, "below_filter": 0,
          "missed": 1.0}
SCORES = "   A  C  G  T\nA  1 -5 -5 -5\nC -5  1 -5 -5\nG -5 -5  1 -5\n" \
         "T -5 -5 -5  1\n"


@pytest.fixture(scope="module")
def read_cell(tmp_path_factory):
    """A checkout holding one read-mapping cell and nothing of the
    harness's code: the judge is chosen by the configuration alone."""
    root = tmp_path_factory.mktemp("checkout")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["workloads"] = [{"name": "readmap.reads101", "config": "readmap",
                          "traffic": "reads101", "chips": 1, "why": "test"}]
    spec["per_layer"] = []
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for d in ("configs", "traffic", "cells"):
        (root / "portbench" / d).mkdir(parents=True)
    (root / "portbench/configs/readmap.json").write_text(json.dumps(CONFIG))
    (root / "portbench/configs/match_1_5.q").write_text(SCORES)
    (root / "portbench/traffic/reads101.json").write_text(json.dumps(READS))
    (root / "portbench/cells/readmap.reads101.json").write_text(
        json.dumps({"sample_queries": 10_000, "limits": LIMITS}))
    return Cell("readmap.reads101", root=str(root))


@pytest.fixture(scope="module")
def sound(read_cell, tmp_path_factory):
    """One window of the port on the CPU: (run, its records)."""
    import torch
    mp = pytest.MonkeyPatch()
    mp.setenv("LASTZ_TORCH_DEVICE", "cpu")
    try:
        run, _ = measure(read_cell, SEED, 3.0, False, torch.device("cpu"),
                         time.monotonic(),
                         str(tmp_path_factory.mktemp("run")))
    finally:
        mp.undo()
    return run


def numbers(cell, run, fault=None):
    return check(cell, run, copy.deepcopy(run.records), fault)


def test_judge_is_chosen_by_the_configuration(read_cell):
    assert read_cell.check_name == "anyornone"
    assert read_cell.judge().NUMBERS == tuple(LIMITS)
    assert Cell("ucsc_mammal.ortholog").check_name == "check"


def test_sound_output_passes(read_cell, sound):
    got, facts = numbers(read_cell, sound)
    assert facts["reads"] >= 20, facts
    # some reads are answered, the junk ones and those in repeats not
    assert 0 < facts["answered"] < facts["reads"], facts
    assert facts["sampled"] == facts["reads"]
    # the reference finds an answer for the reads the port answered
    assert facts["sampled_answerable"] >= facts["sampled_answered"], facts
    for k in ("sam_unreadable", "multiple", "below_filter"):
        assert got[k] == 0, (got, facts)
    assert got["missed"] <= 1.0, (got, facts)


@pytest.mark.parametrize("fault, number", [
    ("control_plus_strand", "missed"), ("half_dropped", "missed"),
    ("altered", "below_filter"), ("duplicated", "multiple"),
    ("unfiltered", "below_filter")])
def test_control_and_faults_fail(read_cell, sound, fault, number):
    got, facts = numbers(read_cell, sound, fault)
    assert got[number] > LIMITS[number], (fault, got, facts)


@pytest.mark.parametrize("line, why", [
    ("{name}\t0\ttarget\t{pos}\t255\t100M\t*\t0\t0\t{seq}\t*", "cigar"),
    ("{name}\t0\ttarget\t{pos}\t255\t101M\t*\t0\t0\t{seq}", "fields"),
    ("other\t0\ttarget\t{pos}\t255\t101M\t*\t0\t0\t{seq}\t*", "name"),
    ("{name}\t0\ttarget\t999990\t255\t101M\t*\t0\t0\t{seq}\t*", "outside"),
    ("{name}\t16\ttarget\t{pos}\t255\t101M\t*\t0\t0\t{seq}\t*", "seq"),
])
def test_unreadable_lines(read_cell, sound, line, why):
    run = copy.copy(sound)
    recs = copy.deepcopy(sound.records)
    rec = next(r for r in recs if r.text.strip() and len(r.seq) == 101
               and "\t0\t" in r.text and "101M" in r.text)
    f = rec.text.strip().split("\t")
    rec.text = line.format(name=rec.name, pos=f[3], seq=f[9]) + "\n"
    got, _ = check(read_cell, run, recs)
    assert got["sam_unreadable"] == 1, why


def test_whole_run_is_correct(read_cell, tmp_path, monkeypatch):
    import torch
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    r = execute(read_cell, SEED + 1, 2.0, False, torch.device("cpu"),
                time.monotonic(), str(tmp_path), log=io.StringIO())
    assert r["correct"], r["checks"]
    assert list(r["checks"]) == list(LIMITS)


def test_judge_imports_nothing_forbidden():
    code = ("import sys; import portbench.reference.anyornone; "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            f"set({FORBIDDEN!r} + ('lastz_tpu_torch',))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_reference_search_on_planted_reads():
    """The reference's own search: an untrimmed end keeps a mismatch in
    the read's last base, an insertion gives one gap, a random read has
    no HSP."""
    import numpy as np
    from portbench.reference import anyornone as ay
    from portbench.reference.scoring import Scores
    acgt = np.frombuffer(b"ACGT", np.uint8)
    matrix = np.full((4, 4), -5)
    np.fill_diagonal(matrix, 1)
    scores = Scores(matrix, 17, 2)
    cfg = CONFIG["reference"]
    rng = np.random.default_rng(1)
    t = acgt[rng.integers(0, 4, 5000)]
    index = ay.StepIndex(t, cfg["seed_pattern"], cfg["step"])
    read = t[1000:1101].copy()
    read[[50, 100]] = acgt[(np.searchsorted(acgt, read[[50, 100]]) + 1) % 4]
    hsps = ay.hsps(index, t, read, cfg["exact"])
    assert hsps == [(1000, 0, 50), (1051, 51, 49)]
    got = ay.gapped(t, read, 1015, 15, scores, cfg)
    assert got == (1000, 0, [("M", 101)])
    assert ay.rescore(t, read, *got, scores) == (89, 99 / 101, 101, 101)
    ins = np.concatenate([t[2000:2050], acgt[[0, 1]], t[2050:2099]])
    got = ay.gapped(t, ins, 2015, 15, scores, cfg)
    assert got == (2000, 0, [("M", 50), ("I", 2), ("M", 49)])
    assert ay.answerable(index, t, ay.revcomp(ins), scores, cfg)
    assert not ay.answerable(index, t, acgt[rng.integers(0, 4, 101)],
                             scores, cfg)
