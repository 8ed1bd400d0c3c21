"""A run that cannot be measured ends by name: no device work in the
warm-up or the window, an empty or impossible device trace, or a window
that completed no query, gives exit code 5, the cause on standard error
and nothing on standard output."""

import os
import time

import pytest
import torch

from portbench import cellrun, control, guard
from portbench.bench import Cell, Record, Run
from portbench.trace import Spans, device_reading

SMALL_GENOME = {"target_bp": 60_000, "families": 10}
SMALL_TRAFFIC = {"record_bp": [2_000, 3_000], "block_bp": [400, 1_000]}


def test_guard_on_readings():
    # off the card: no reading, no guard
    guard.require_work(None, None, "warm-up")
    guard.require_work(10, 11, "warm-up")
    for stage in ("warm-up", "window"):
        with pytest.raises(guard.NoDeviceWork) as e:
            guard.require_work(10, 10, stage)
        assert e.value.stage == stage
        assert "put no work on the card" in str(e.value)
        assert stage.replace("window", "measured window") in str(e.value)


@pytest.fixture
def small_run(monkeypatch, tmp_path):
    """A Run of the mammal cell at a small size on the CPU, the guard's
    reading of device work replaced by `counts` (one value a read)."""
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    import lastz_tpu_torch.align.ydrop_device as yd
    monkeypatch.setattr(yd, "DEFAULT_WIDTH", 128)
    monkeypatch.setattr(yd, "DEFAULT_ROWS", 64)
    monkeypatch.setattr(yd, "DEFAULT_BATCH", 16)

    def make(counts):
        it = iter(counts)
        monkeypatch.setattr(guard, "work_count", lambda device: next(it))
        return Run(Cell("ucsc_mammal.ortholog"), 2**31 + 21,
                   torch.device("cpu"), str(tmp_path), SMALL_GENOME,
                   SMALL_TRAFFIC)
    return make


@pytest.mark.parametrize("counts, stage", [
    ([7, 7], "warm-up"), ([7, 9, 9, 9], "window"), ([7, 9, 9, 12], None)])
def test_guard_in_a_run(small_run, counts, stage):
    """The warm-up and the window each read the count before and after:
    a count that does not move ends the run there; one that moves in
    both lets it through."""
    run = small_run(counts)
    if stage == "warm-up":
        with pytest.raises(guard.NoDeviceWork, match="warm-up query"):
            run.setup()
        return
    run.setup()
    if stage == "window":
        with pytest.raises(guard.NoDeviceWork, match="measured window"):
            run.window(0.2)
    else:
        assert run.window(0.2)


def trace_reading(intervals, window_s):
    return device_reading(list(intervals), window_s, 100.0, Spans())


@pytest.mark.parametrize("intervals, window_s, cause", [
    ([], 1.0, "holds no operation"),
    ([(0, 1_500_000, "k")], 1.0, "outside 0 < busy_s <= window_s"),
    ([(0, 0, "k")], 1.0, "outside 0 < busy_s <= window_s"),
])
def test_trace_out_of_limits(intervals, window_s, cause):
    with pytest.raises(guard.NoDeviceWork, match=cause) as e:
        guard.traced(trace_reading(intervals, window_s))
    assert e.value.stage == "trace"


def test_sound_trace_keeps_both_keys():
    got = guard.traced(trace_reading(
        [(0, 100_000, "k1"), (50_000, 200_000, "k2"),
         (600_000, 700_000, "k1")], 1.0))
    assert got["busy_s"] == pytest.approx(0.3)
    assert got["window_s"] == 1.0
    assert 0 < got["busy_s"] <= got["window_s"]


def test_empty_window_is_named(tmp_path):
    """A window whose records never complete (no `done`) ends with
    EmptyWindow, not an IndexError."""
    run = Run(Cell("ucsc_mammal.ortholog"), 1, torch.device("cpu"),
              str(tmp_path))
    run.drive = lambda source, stop: ([Record("q0", "ACGT")],
                                      time.monotonic())
    with pytest.raises(guard.EmptyWindow, match="no query completed"):
        run.window(0.1)


FAILURES = [guard.NoDeviceWork("warm-up"), guard.NoDeviceWork("window"),
            guard.NoDeviceWork("trace"),
            guard.NoDeviceWork("trace", "the device trace reads 2.0 s busy "
                               "in a window of 1.0 s"),
            guard.EmptyWindow()]


@pytest.fixture
def on_a_card(monkeypatch):
    """The look for a card answers yes, and main's edits of the
    environment are undone afterwards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in list(os.environ.items()):
        if k.startswith("LASTZ_TORCH_"):
            monkeypatch.setenv(k, v)
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("failure", FAILURES, ids=lambda f: str(f)[:40])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_main_ends_unmeasurable_runs_by_name(on_a_card, monkeypatch,
                                             capsys, failure, trace):
    def execute(*a, **k):
        raise failure
    monkeypatch.setattr(cellrun, "execute", execute)
    rc = cellrun.main(["--workload", "ucsc_mammal.ortholog", "--seed",
                       str(2**33 + 5), "--seconds", "51", "--trace", trace],
                      time.monotonic())
    out, err = capsys.readouterr()
    assert rc == guard.EXIT_CODE == 5
    assert out == ""
    last = err.strip().splitlines()[-1]
    assert str(failure) in last and failure.stage in last


def test_control_ends_unmeasurable_runs_by_name(on_a_card, monkeypatch,
                                                capsys, tmp_path):
    def measure(*a, **k):
        raise guard.NoDeviceWork("warm-up")
    monkeypatch.setattr(cellrun, "measure", measure)
    rc = control.main(["--workload", "ucsc_mammal.ortholog", "--seeds",
                       "1,2", "--out", str(tmp_path / "readings.jsonl")])
    out, err = capsys.readouterr()
    assert rc == 5 and out == ""
    assert "put no work on the card during the warm-up query" in err
