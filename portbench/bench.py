"""One run of one cell: set-up, the measured window, the readings.

Set-up, paid once a process as LASTZ pays it: the genome model and the
query pool from the seed, the configuration's options through the
program's own parser, the target loaded and indexed once on the card,
and one short warm-up query of the cell's own traffic. The window then
drives `Pipeline.run(target=T, pt=PT)`, the CLI's own query loop, with
a query file whose `load()` hands over one record at a time until the
window's seconds are spent; the output (LAV, SAM, whatever the
configuration's options ask for) goes to an in-memory sink. A query is
timed from its handover to the end of its processing, when its last
output byte is written. The warm-up and the window each have to put
work on the card (guard.py).
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import re
import time

import numpy as np

from . import guard
from .genome import WARM_KEY, GenomeModel, fasta
from .trace import Spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM_BP = 60_000
# query bases made in set-up, and at most so many records, so that a
# traffic of short reads makes its pool in well under a second; records
# past them are made on demand from (seed, index) alike
POOL_BP = 10_000_000
POOL_RECORDS = 2048
# a configuration's "check" names its judge, portbench/reference/<check>.py
CHECK = re.compile(r"^[a-z][a-z0-9_]*$")
DEFAULT_CHECK = "check"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json and the files its names lead to."""

    def __init__(self, name: str, root: str = ROOT):
        spec = load_json(root, "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}")
        self.spec = spec
        self.workload = cells[name]
        self.name = name
        self.config = load_json(root, "portbench", "configs",
                                self.workload["config"] + ".json")
        self.traffic = load_json(root, "portbench", "traffic",
                                 self.workload["traffic"] + ".json")
        self.limits = load_json(root, "portbench", "cells", name + ".json")
        self.root = root
        self.check_name = self.config.get("check", DEFAULT_CHECK)
        if not CHECK.match(self.check_name):
            raise SystemExit(f"bad check name {self.check_name!r}")

    def judge(self):
        """The module that decides `correct` for this configuration: its
        `NUMBERS` and `judge(...)`."""
        return importlib.import_module("portbench.reference."
                                       + self.check_name)

    def metrics(self, kind: str) -> list[dict]:
        """The cell's end_to_end or per_layer metrics."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def options(self) -> list[str]:
        return [o.replace("{configs}",
                          os.path.join(self.root, "portbench", "configs"))
                for o in self.config["options"]]


class Record:
    """A query record in the window."""

    __slots__ = ("name", "seq", "handover", "done", "offset", "timers",
                 "counts", "anchors", "tweener_s", "text")

    def __init__(self, name, seq):
        self.name = name
        self.seq = seq
        self.handover = self.done = None
        self.offset = 0
        self.timers = {}
        self.counts = {}
        self.anchors = {}
        self.tweener_s = 0.0
        # the output the program wrote for this record, in the
        # configuration's format
        self.text = ""


class Feeder:
    """The query file of the window: `load()` hands over the next record
    (the port's own FASTA reader parses it) until `stop()` says so."""

    def __init__(self, source, tmpdir, sink, stop, spans):
        self.source = source
        self.spans = spans
        self.path = os.path.join(tmpdir, "query.fa")
        self.sink = sink
        self.stop = stop
        self.records: list[Record] = []
        self.current: Record | None = None
        self.spec = None

    def load(self):
        with self.spans.span("query file"):
            return self._load()

    def _load(self):
        from lastz_tpu_torch.io.sequence import SequenceFile
        if self.stop(self):
            return None
        index = len(self.records)
        name, seq = self.source(index)
        with open(self.path, "wb") as f:
            f.write(fasta(name, seq))
        query = SequenceFile(self.path).load()
        rec = Record(name, seq)
        rec.offset = self.sink.tell()
        rec.handover = time.monotonic()
        self.records.append(rec)
        self.current = rec
        return query


TIMERS = ("seed search", "hitgen report", "hitgen setup", "gapped",
          "ydrop device", "ydrop host")
COUNTS = ("gapped_device", "gapped_host")


def make_pipeline_class():
    from lastz_tpu_torch.pipeline import Pipeline

    class TimedPipeline(Pipeline):
        """The program's pipeline with the harness's per-query hook."""

        feeder: Feeder = None

        def _start_one_strand(self, *a, **k):
            with self.feeder.spans.span("seed stage"):
                return super()._start_one_strand(*a, **k)

        def _finish_one_strand(self, *a, **k):
            with self.feeder.spans.span("gapped stage and output"):
                return super()._finish_one_strand(*a, **k)

        def _run_query(self, target, pt, query, *rest):
            rec = self.feeder.current
            st = self.stats
            t0 = dict(st.timers)
            c0 = {k: getattr(st, k) for k in COUNTS}
            super()._run_query(target, pt, query, *rest)
            rec.done = time.monotonic()
            rec.timers = {k: st.timers.get(k, 0.0) - t0.get(k, 0.0)
                          for k in TIMERS}
            rec.counts = {k: getattr(st, k) - c0[k] for k in COUNTS}

    return TimedPipeline


@contextlib.contextmanager
def patched(module, name, fn):
    own = getattr(module, name)
    setattr(module, name, fn(own))
    try:
        yield
    finally:
        setattr(module, name, own)


@contextlib.contextmanager
def hooks(feeder):
    """The window's hooks: the query file, the anchors handed to gapped
    extension, and a span around the tweener."""
    import lastz_tpu_torch.pipeline as pl
    import lastz_tpu_torch.align.ydrop as yd
    import lastz_tpu_torch.align.tweener as tw

    def open_file(own):
        def sequence_file(name, *a, **k):
            return feeder if name == feeder.path else own(name, *a, **k)
        return sequence_file

    def keep_anchors(own):
        def reduce_to_points(v1, v2, scoring, anchors):
            if anchors is not None and feeder.current is not None:
                rows = [(s.pos1, s.pos2, s.length, s.score, s.seg_id)
                        for s in anchors.segments]
                arr = np.array(rows, dtype=np.int64).reshape(-1, 5)
                for rc in (0, 1):
                    pick = ((arr[:, 4] & 2) != 0) == bool(rc)
                    if pick.any():
                        feeder.current.anchors[rc] = arr[pick, :4]
            return own(v1, v2, scoring, anchors)
        return reduce_to_points

    def span(own):
        def tweener_interpolate(*a, **k):
            t0 = time.monotonic()
            try:
                with feeder.spans.span("tweener"):
                    return own(*a, **k)
            finally:
                if feeder.current is not None:
                    feeder.current.tweener_s += time.monotonic() - t0
        return tweener_interpolate

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(pl, "SequenceFile", open_file))
        stack.enter_context(patched(yd, "reduce_to_points", keep_anchors))
        stack.enter_context(patched(tw, "tweener_interpolate", span))
        yield


def make_pool(model: GenomeModel, traffic: dict, bp: float) -> list:
    """The records made in set-up, (name, bases) from index 0: until
    they hold `bp` bases or POOL_RECORDS records."""
    pool = []
    total = 0
    while total < bp and len(pool) < POOL_RECORDS:
        name, seq, _ = model.record(traffic, len(pool))
        pool.append((name, seq))
        total += len(seq)
    return pool


class Run:
    """Set-up and window of one cell on one device."""

    def __init__(self, cell: Cell, seed: int, device, tmpdir: str,
                 genome_override=None, traffic_override=None):
        self.cell = cell
        self.seed = seed
        self.device = device
        self.tmpdir = tmpdir
        self.genome = dict(cell.config["genome"], **(genome_override or {}))
        self.traffic = dict(cell.traffic, **(traffic_override or {}))
        self.spans = Spans()

    def setup(self):
        from lastz_tpu_torch.cli import parse_options
        from lastz_tpu_torch.io.sequence import SequenceFile
        self.model = GenomeModel(self.seed, self.genome)
        self.pool = make_pool(self.model, self.traffic,
                              POOL_BP * self.genome["target_bp"] / 20_010_000)
        self.target_path = os.path.join(self.tmpdir, "target.fa")
        with open(self.target_path, "wb") as f:
            f.write(fasta("target", self.model.target))
        self.query_path = os.path.join(self.tmpdir, "query.fa")
        self.argv = [self.target_path, self.query_path, *self.cell.options()]
        self.parse = lambda: parse_options(list(self.argv))
        self.target = SequenceFile(self.target_path).load()
        Pipeline = make_pipeline_class()
        builder = Pipeline(self.parse(), out=io.StringIO(),
                           device=self.device)
        self.pt = builder._build_position_table(self.target)
        # warm-up: one short query of the cell's traffic, no longer
        # than its longest record
        warm = min(WARM_BP, self.traffic["record_bp"][1])
        name, seq, _ = self.model.record(self.traffic, 0, length=warm,
                                         key=WARM_KEY)
        before = guard.work_count(self.device)
        self.drive(lambda i: (name, seq), lambda f: len(f.records) >= 1)
        self.sync()
        guard.require_work(before, guard.work_count(self.device), "warm-up")

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def source(self, index):
        if index < len(self.pool):
            return self.pool[index]
        name, seq, _ = self.model.record(self.traffic, index)
        return name, seq

    def drive(self, source, stop):
        """One Pipeline.run over the records `source` gives until `stop`."""
        sink = io.StringIO()
        feeder = Feeder(source, self.tmpdir, sink, stop, self.spans)
        Pipeline = make_pipeline_class()
        pipe = Pipeline(self.parse(), out=sink, device=self.device)
        pipe.feeder = feeder
        with hooks(feeder):
            pipe.run(target=self.target, pt=self.pt)
        end = time.monotonic()
        text = sink.getvalue()
        recs = feeder.records
        for k, rec in enumerate(recs):
            stop_at = recs[k + 1].offset if k + 1 < len(recs) else len(text)
            rec.text = text[rec.offset:stop_at]
        return recs, end

    def window(self, seconds: float):
        """The measured window: queries until `seconds` after the first
        handover; the last one in flight runs to its end. It has to put
        work on the card and complete a query (guard.py)."""
        def stop(feeder):
            recs = feeder.records
            return bool(recs) and time.monotonic() - recs[0].handover \
                >= seconds
        before = guard.work_count(self.device)
        self.records_all, _ = self.drive(self.source, stop)
        self.sync()
        self.end = time.monotonic()
        guard.require_work(before, guard.work_count(self.device), "window")
        self.records = [r for r in self.records_all if r.done is not None]
        if not self.records:
            raise guard.EmptyWindow()
        self.start = self.records[0].handover
        return self.records
