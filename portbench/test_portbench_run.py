"""Whole runs at a small size: the harness without its look for a card
drives the program on the CPU, and the check finds the output correct;
with the control or a planted fault underneath, it finds it wrong."""

import io
import os
import tempfile
import time

import pytest

from portbench.bench import Cell
from portbench.cellrun import execute

SMALL_GENOME = {"target_bp": 150_000, "families": 20}
SMALL_TRAFFIC = {"record_bp": [8_000, 12_000], "block_bp": [400, 2_000]}


@pytest.fixture
def small_port(monkeypatch):
    """The program on the CPU with its gapped stage's geometry shrunk,
    so that its plain versions finish in seconds."""
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    import lastz_tpu_torch.align.ydrop_device as yd
    monkeypatch.setattr(yd, "DEFAULT_WIDTH", 128)
    monkeypatch.setattr(yd, "DEFAULT_ROWS", 64)
    monkeypatch.setattr(yd, "DEFAULT_BATCH", 16)


def small_run(cell, fault=None, device="cpu", seconds=1.0, trace=False):
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        return execute(Cell(cell), 2**31 + 11, seconds, trace,
                       torch.device(device), time.monotonic(), tmp,
                       genome=SMALL_GENOME, traffic=SMALL_TRAFFIC,
                       fault=fault, log=io.StringIO())


def test_sound_run_agrees(small_port):
    r = small_run("ucsc_mammal.ortholog")
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values()), r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"align_mbp_per_s", "setup_s"}
    assert list(r)[-1] == "checks"


def test_traced_run_reads_the_host_layers(small_port):
    """Without a card the traced run reads the program's timers and the
    harness's spans; the device readers find nothing and say so."""
    r = small_run("ucsc_mammal.ortholog", trace=True)
    m = r["metrics"]
    for name in ("pipeline.query_p95_s", "pipeline.host_s_per_mbp",
                 "search.seed_s_per_mbp", "search.replay_s_per_mbp",
                 "align.gapped_s_per_mbp"):
        assert m[name]["value"] > 0, name
    for name in ("kernels.k1_mega_roofline", "kernels.k2_roofline",
                 "device.idle_share"):
        assert name not in m
    assert "breakdown" not in r


@pytest.mark.parametrize("fault", ["control_int16", "control_plus_strand",
                                   "unchanged", "half_dropped", "altered",
                                   "duplicated", "unfiltered"])
def test_control_and_faults_fail(small_port, fault):
    r = small_run("ucsc_mammal.ortholog", fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault, number", [("duplicated", "duplicates"),
                                           ("unfiltered", "below_threshold")])
def test_output_faults_show_in_their_own_number(small_port, fault, number):
    r = small_run("ucsc_mammal.ortholog", fault=fault)
    assert r["checks"][number]["value"] > 0, r["checks"]


@pytest.mark.cuda
def test_card_run(cuda_device):
    r = small_run("ucsc_mammal.ortholog", device=cuda_device, seconds=3.0)
    assert r["correct"], r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0
