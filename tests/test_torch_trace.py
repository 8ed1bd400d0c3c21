"""The port's spans and counters (lastz_tpu_torch/stats.py) on the CPU:
a small pipeline run traced and not, the spans' nesting, ordinals and
strands against the RunStats buckets, the same output either way, the
spans on torch.profiler's clock, and the benchmark's readers of them
(portbench/metrics/, portbench/program_idle.py) on synthetic readings.
This file imports no JAX."""

import io
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lastz_tpu_torch.align.ydrop_device as tydd
from lastz_tpu_torch import stats
from lastz_tpu_torch.cli import parse_options
from lastz_tpu_torch.pipeline import Pipeline
from portbench.cellrun import reader
from portbench.program_idle import ProgramSpans, gaps
import torch_threads  # noqa: F401  (a share of the cores per xdist worker)

# the buckets the benchmark's harness reads (portbench/bench.py TIMERS)
HARNESS_TIMERS = ("seed search", "hitgen report", "hitgen setup", "gapped",
                  "ydrop device", "ydrop host")
NEW_METRICS = ("search.target_setup_s_per_mbp",
               "search.query_setup_s_per_mbp",
               "search.device_wait_s_per_mbp",
               "align.target_setup_s_per_mbp",
               "align.device_wait_s_per_mbp",
               "align.accept_self_s_per_mbp", "device.upload_mb_per_mbp")


def write_pair(d, n=1500, seed=5):
    """A target and a query file of two records, each an interval of
    the target at 8% substitutions and a few deletions, the second one
    reverse-complemented."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    t = alpha[rng.integers(0, 4, n)]
    recs = []
    for lo, hi in ((100, 700), (800, 1400)):
        s = t[lo:hi].copy()
        mut = rng.random(len(s)) < 0.08
        s[mut] = alpha[rng.integers(0, 4, mut.sum())]
        recs.append(bytes(np.delete(s, rng.integers(0, len(s), 6))))
    recs[1] = recs[1][::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    tp, qp = d / "t.fa", d / "q.fa"
    tp.write_text(">t\n" + bytes(t).decode() + "\n")
    qp.write_text("".join(f">q{i}\n{r.decode()}\n"
                          for i, r in enumerate(recs)))
    return str(tp), str(qp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pair's job (with the tweener) untraced, then traced: each
    run's LAV and RunStats, and the traced run's spans. One retained
    block of 64 rows, so that some extensions go to the host engine."""
    t, q = write_pair(tmp_path_factory.mktemp("pair"))
    args = [t, q, "--ydrop=3000", "H=2000"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LASTZ_TORCH_DEVICE", "cpu")
        for k, v in (("DEFAULT_WIDTH", 128), ("DEFAULT_ROWS", 64),
                     ("DEFAULT_BATCH", 8), ("DEFAULT_BLOCKS", 1)):
            mp.setattr(tydd, k, v)
        out = {}
        for on in (False, True):
            before = len(stats.recorded().spans)
            sink = io.StringIO()
            pipe = Pipeline(parse_options(list(args)), sink)
            if on:
                with stats.tracing() as tr:
                    pipe.run()
                out["spans"] = tr.spans
            else:
                pipe.run()
                out["off_spans"] = len(stats.recorded().spans) - before
            out[on] = (sink.getvalue(), pipe.stats)
    return out


def dur(s):
    return s.t1 - s.t0


def test_children_lie_inside_their_parents(runs):
    spans = runs["spans"]
    assert len(spans) > 20
    for s in spans:
        assert s.t1 is not None and s.t0 <= s.t1
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1, s.name
    names = {(s.name, s.parent.name if s.parent else None) for s in spans}
    for pair in [("query", None), ("strand", "query"),
                 ("seed search", "strand"), ("hitgen setup", "seed search"),
                 ("hitgen setup target", "hitgen setup"),
                 ("hitgen setup query", "hitgen setup"),
                 ("hitgen wait", "hitgen device"), ("gapped", "strand"),
                 ("ydrop setup target", "gapped"),
                 ("ydrop device", "gapped"), ("ydrop wait", "ydrop device"),
                 ("tweener", "strand")]:
        assert pair in names, pair


def test_spans_carry_their_query_and_strand(runs):
    spans = runs["spans"]
    queries = [s for s in spans if s.name == "query"]
    assert [s.query for s in queries] == [1, 2]
    for s in spans:
        if s.parent is None:
            assert s.name in ("query", "pos table"), s.name
            continue
        assert s.query in (1, 2), s.name
        if s.name != "strand":
            assert s.strand == s.parent.strand
    assert {(s.query, s.strand) for s in spans if s.name == "strand"} == {
        (1, "+"), (1, "-"), (2, "+"), (2, "-")}
    assert all(s.strand in ("+", "-") for s in spans
               if s.name not in ("query", "pos table"))


def test_setup_children_within_setup(runs):
    spans = runs["spans"]
    setups = [s for s in spans if s.name == "hitgen setup"]
    assert setups
    for p in setups:
        kids = [s for s in spans if s.parent is p
                and s.name.startswith("hitgen setup ")]
        assert {s.name for s in kids} == {"hitgen setup target",
                                          "hitgen setup query"}
        assert sum(dur(s) for s in kids) <= dur(p)
    timers = runs[True][1].timers
    assert (timers["hitgen setup target"] + timers["hitgen setup query"]
            <= timers["hitgen setup"])


def test_buckets_keep_their_names_and_totals(runs):
    off, on = runs[False][1].timers, runs[True][1].timers
    assert set(off) == set(on)
    assert set(HARNESS_TIMERS) <= set(on)
    spans = runs["spans"]
    for name, total in on.items():
        if name == "ydrop host":
            continue
        got = sum(dur(s) for s in spans if s.name == name)
        assert got == pytest.approx(total, rel=1e-9, abs=1e-12), name
    # work timed once an anchor is a bucket and no span; its time is in
    # the spans it ran inside
    assert on["ydrop host"] > 0
    assert not any(s.name == "ydrop host" for s in spans)
    inner = sum((s.inner or {}).get("ydrop host", 0.0) for s in spans)
    assert inner == pytest.approx(on["ydrop host"], rel=1e-9)
    assert runs[True][1].gapped_host > 0


def test_counters_and_their_deltas(runs):
    st = runs[True][1]
    for k in ("upload hits", "digest bytes"):
        assert st.extra[k] > 0, k
    spans = runs["spans"]
    # the query spans' deltas add up to the job's counts
    queries = [s for s in spans if s.name == "query"]
    assert sum(s.counts.get("alignments", 0) for s in queries) \
        == st.alignments > 0
    assert sum(s.counts.get("digest bytes", 0) for s in queries) \
        == st.extra["digest bytes"]
    # the run's target handle: built on the first query, reused after,
    # never patched without masking
    assert st.extra["target builds"] > 0
    assert st.extra["target reuses"] >= 2 * len(queries)
    assert st.extra["target patches"] == st.extra["target patch bytes"] == 0
    for k in ("target reuses", "target builds"):
        assert sum(s.counts.get(k, 0) for s in queries) == st.extra[k], k
    assert queries[1].counts.get("target builds", 0) == 0
    # the seed stage's replay: every survivor through the array replay
    # (an integer score threshold, no search limit, an extension)
    replay = ("replay candidates", "replay bulk candidates",
              "replay bind re-extensions", "replay entropy rows")
    assert st.extra["replay bulk candidates"] \
        == st.extra["replay candidates"] > 0
    assert st.extra["replay entropy rows"] > 0
    for k in replay:
        assert sum(s.counts.get(k, 0) for s in queries) == st.extra[k], k
    out = io.StringIO()
    st.show(out)
    for k in ("upload hits", "digest bytes", "hitgen setup target",
              "ydrop wait", "tweener", "target reuses", "target builds",
              "target patches", "target patch bytes") + replay:
        assert k in out.getvalue(), k


def test_tracing_off_records_no_span(runs):
    assert runs["off_spans"] == 0


def test_output_is_the_same_traced_or_not(runs):
    assert runs[True][0] == runs[False][0]
    assert runs[True][0].count("a {") >= 2


def test_spans_map_onto_the_profilers_clock():
    """Program spans between record_function markers (an outer one
    around the span, an inner one inside it), 0.4 s apart over 1.2 s,
    mapped through the trace's clock pairs and the profile's start,
    lie between the markers' profiler times within 100 us."""
    st = stats.RunStats()
    with torch.autograd.profiler.record_function("warm-up"):
        pass
    with stats.tracing() as tr, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(4):
            with torch.autograd.profiler.record_function(f"outer{i}"):
                with st.time(f"span{i}"):
                    with torch.autograd.profiler.record_function(
                            f"inner{i}"):
                        time.sleep(0.01)
            time.sleep(0.39)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ev = {e.name: e.time_range for e in prof.events()}
    spans = {s.name: s for s in tr.spans}
    assert len(spans) == 4

    def us(t):
        return (tr.unix_ns(t) - start_ns) / 1e3

    first, last = ev["outer0"].start, ev["outer3"].start
    assert last - first >= 1e6
    for i in range(4):
        s, o, n = spans[f"span{i}"], ev[f"outer{i}"], ev[f"inner{i}"]
        assert o.start - 100 <= us(s.t0) <= n.start + 100, i
        assert n.end - 100 <= us(s.t1) <= o.end + 100, i


def test_a_profiler_turns_tracing_on():
    """The benchmark's traced run profiles its window and sets no switch
    of the program's: spans go to the process's trace while a profiler
    records, and not after."""
    st = stats.RunStats()
    n0 = len(stats.recorded().spans)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with st.span("query", query=7):
            with st.time("seed search"):
                pass
    with st.time("seed search"):
        pass
    got = stats.recorded().spans[n0:]
    assert [(s.name, s.query) for s in got] == [("query", 7),
                                                ("seed search", 7)]


class FakeClock:
    """time.monotonic and time.time_ns for stats.py, moved by hand."""

    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def time_ns(self):
        return int(self.t * 1e9) + 5_000_000_000


def synthetic_reading(monkeypatch):
    """Inside a tracing() block: one window record of 0.5 Mbp whose
    query span holds known spans (seconds), and a tweener whose inner
    spans the stage metrics leave out; returns the reading."""
    clock = FakeClock()
    monkeypatch.setattr(stats, "_time", clock)
    st = stats.RunStats()

    def step(s):
        clock.t += s

    rec = SimpleNamespace(handover=clock.t, done=None)
    step(0.01)
    with st.span("query", query=1):
        with st.span("strand", strand="+"):
            with st.time("seed search"):
                with st.time("hitgen setup"):
                    with st.time("hitgen setup target"):
                        st.add("upload bytes", 3_000_000)
                        step(0.25)
                    with st.time("hitgen setup query"):
                        step(0.125)
                        with st.time("hitgen wait"):
                            step(0.0625)
                with st.time("hitgen device"):
                    with st.time("hitgen wait"):
                        step(0.5)
            with st.time("gapped"):
                with st.time("ydrop setup target"):
                    step(0.75)
                step(1.0)  # the accept loop
                with st.time("ydrop device"):
                    with st.time("ydrop wait"):
                        step(2.0)
                with st.time("ydrop host", span=False):
                    step(4.0)
            with st.time("tweener"):
                with st.time("hitgen setup target"):
                    step(8.0)
                with st.time("hitgen wait"):
                    step(8.0)
                with st.time("ydrop host", span=False):
                    step(8.0)
    step(0.01)
    rec.done = clock.t
    return {"records": [rec], "mbp": 0.5, "window_s": 30.0,
            "walls": np.array([rec.done - rec.handover]),
            "launches": None, "device": None}


EXPECTED = {"search.target_setup_s_per_mbp": 0.25 / 0.5,
            "search.query_setup_s_per_mbp": 0.1875 / 0.5,
            "search.device_wait_s_per_mbp": 0.5625 / 0.5,
            "align.target_setup_s_per_mbp": 0.75 / 0.5,
            "align.device_wait_s_per_mbp": 2.0 / 0.5,
            "align.accept_self_s_per_mbp": 1.0 / 0.5,
            "device.upload_mb_per_mbp": 3.0 / 0.5}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_on_a_synthetic_reading(monkeypatch, name):
    with stats.tracing():
        r = synthetic_reading(monkeypatch)
        assert reader(name)(r) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_finds_nothing_to_read(monkeypatch, name):
    """No span in the window (a query outside every record, tracing
    off), and a program without spans (a parent checkout): None."""
    with stats.tracing():
        r = synthetic_reading(monkeypatch)
        r["records"][0].handover += 0.02
        assert reader(name)(r) is None
    with stats.tracing():
        assert reader(name)(synthetic_reading(monkeypatch) | {
            "records": []}) is None
    monkeypatch.delattr(stats, "recorded")
    assert reader(name)({"records": [], "mbp": 1.0}) is None


def test_idle_gaps_named_by_program_span():
    """ProgramSpans names a gap by the innermost program span on the
    profile's timeline, divides a gap among the spans it crosses, and
    falls back to the harness's span."""
    tr = stats.Trace()
    tr._mono[:], tr._unix[:] = [10.0], [7_000_000_000]

    def span(name, t0, t1, parent=None):
        s = stats.Span(name, parent, None, None)
        s.t0, s.t1 = t0, t1
        tr.spans.append(s)
        return s

    q = span("query", 10.5, 14.0)
    g = span("gapped", 11.0, 13.0, q)
    span("ydrop wait", 12.0, 12.5, g)
    harness = SimpleNamespace(label=lambda times: [
        "seed stage" if t < 51 else "between queries" for t in times])
    # the profile started at Unix 7.2 s; its host0 reads 50 s, so the
    # spans lie at 0.3-3.8, 0.8-2.8 and 1.8-2.3 s of the profile
    named = ProgramSpans(tr, 7_200_000_000, 50.0, harness)
    rel = [0.2, 0.4, 1.0, 2.0, 2.4, 3.0, 4.0]
    assert named.label([50.0 + t for t in rel]) == [
        "seed stage", "query", "gapped", "ydrop wait", "gapped", "query",
        "between queries"]
    got = named.split([(0.0, 0.5), (1.5, 1.0), (3.5, 0.75)])
    want = {"seed stage": 0.3, "query": 0.2 + 0.3, "gapped": 0.3 + 0.2,
            "ydrop wait": 0.5, "between queries": 0.45}
    assert got == pytest.approx(want, abs=1e-9)
    assert gaps([(100, 200, "k"), (150, 300, "k"), (1300, 1400, "k")]) == [
        (0.0, 100e-6), (300e-6, 1000e-6)]


def test_traced_cell_run_reads_the_new_metrics(monkeypatch, tmp_path):
    """The benchmark's traced run at a small size on the CPU, its
    window traced (on the card the run's profiler turns tracing on, as
    test_a_profiler_turns_tracing_on shows): every new reader finds
    the spans of the window's queries."""
    from portbench.bench import Cell
    from portbench.cellrun import execute
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    for k, v in (("DEFAULT_WIDTH", 128), ("DEFAULT_ROWS", 64),
                 ("DEFAULT_BATCH", 16)):
        monkeypatch.setattr(tydd, k, v)
    with stats.tracing():
        r = execute(Cell("ucsc_mammal.ortholog"), 2**31 + 11, 1.0, True,
                    torch.device("cpu"), time.monotonic(), str(tmp_path),
                    genome={"target_bp": 150_000, "families": 20},
                    traffic={"record_bp": [8_000, 12_000],
                             "block_bp": [400, 2_000]},
                    log=io.StringIO())
    assert r["correct"], r["checks"]
    m = r["metrics"]
    for name in NEW_METRICS:
        assert m[name]["value"] >= 0, name
    for name in ("search.target_setup_s_per_mbp",
                 "search.query_setup_s_per_mbp",
                 "align.target_setup_s_per_mbp",
                 "align.accept_self_s_per_mbp", "device.upload_mb_per_mbp"):
        assert m[name]["value"] > 0, name
