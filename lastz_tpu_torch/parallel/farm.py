"""Concurrent query farm-out over device slots (port of
lastz_tpu/parallel/farm.py).

The reference's scaling story is the target capsule: build the index
once, then run N *processes in parallel* over query shards, each with
the index mmap-shared (reference capsule.c:6-15).  Here N worker
threads, one per device slot, each run a worker Pipeline over its
query shard (every N-th query, the same interleaving as --shard=i/n)
with the target and position table shared read-only.  A slot is a
device: "cuda:i" or "cpu"; a card may be listed more than once, and
then runs that many workers side by side.

Each worker on a card enters torch.cuda.device(slot) and then
torch.cuda.stream(its own stream) before it builds its pipeline: the
kernels' C entry points launch on the calling thread's current device,
and every wrapper passes torch.cuda.current_stream(), which is the
thread's own.  So the kernels of different queries overlap on the card
while the host glue interleaves under the GIL (numpy, ctypes and the
blocking fetches release it).  A worker synchronizes its stream before
its thread ends.  A CPU slot runs the plain versions, as every CPU run
does.

What the workers share, and why it is safe:
  * the position table: built (or uploaded from a capsule) by the
    parent on its stream.  The parent copies an in-place table to
    every further card once (DevicePositionTable.on) and synchronizes
    each card once before the threads start, so no worker's stream
    reads it before it is written;
  * the upload cache (device._cached): kept per (device, stream), so
    an upload is read, and freed, only on the stream that made it;
  * the launch counters (kernels/build.count) and the native library
    (native.get_lib): each behind a lock;
  * core/scoring.SCORE_TYPE: set by every worker's _finalize_config
    from the same configuration, so always to the same value.

Output is byte-identical to the serial run for any slot count: each
worker captures its queries' output as self-contained chunks (the
dispatcher guarantees chunkability via `farm_chunkable`), and the
parent stitches chunks back in query-stream order.  Job header and
footer are emitted by the parent.

Configurations with cross-query coupling fall back to the serial
round-robin-pinned loop in pipeline.py: dynamic masking / census
(queries couple through the target), chores (one query spans several
loads), segments/anchors input (a sequentially-consumed stream),
search limits (footer summary counts globally), non-chunkable output
formats, and user-level --shard (composes with farm-out awkwardly).
"""

from __future__ import annotations

import contextlib
import copy
import threading

import torch

from ..device import release_stream


class _ChunkWriter:
    """A file-like sink that splits worker output into per-query
    chunks.  Everything before the first begin_query (the worker's
    own job header) and after the last query (the worker's footer)
    is discarded — the parent emits the real header/footer."""

    def __init__(self):
        self.chunks = {}
        self._cur = None

    def begin_query(self, index: int):
        self._cur = []
        self.chunks[index] = self._cur

    def end_queries(self):
        self._cur = None

    def write(self, s: str):
        if self._cur is not None:
            self._cur.append(s)

    def flush(self):
        pass


def farm_supported(pipeline) -> bool:
    """Whether this job can run the concurrent farm-out with output
    byte-identical to the serial run."""
    cfg = pipeline.cfg
    if cfg.shard_count > 1:
        return False
    if cfg.dynamic_masking > 0 or cfg.report_census:
        return False
    if getattr(pipeline, "targ_census", None) is not None:
        return False
    if cfg.chores_filename is not None:
        return False
    if cfg.segments_filename is not None \
            or cfg.anchors_filename is not None:
        return False
    if cfg.search_limit > 0:
        return False
    if cfg.masking_filename is not None \
            or cfg.soft_masked_filename is not None:
        return False
    if cfg.infer_only or getattr(cfg, "inferring", False):
        return False
    if not pipeline.dispatcher.farm_chunkable():
        return False
    if getattr(pipeline.dispatcher, "collector", None) is not None:
        return False
    return True


@contextlib.contextmanager
def on_slot(device):
    """For the block, the calling thread's current card is `device` and
    its current stream there a new one of its own, synchronized and
    its uploads dropped at the end; yields that stream (None for a CPU
    slot, which has no streams)."""
    if device.type != "cuda":
        yield None
        return
    with torch.cuda.device(device):
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            try:
                yield stream
            finally:
                stream.synchronize()
                release_stream(device)


def _share_table(pt, devices) -> None:
    """Before the workers start: an in-place device table copied once
    to every further card, and every card the parent or a worker uses
    synchronized once, so that the parent's build, uploads and copies
    are done before any worker's stream reads them."""
    cards = {d for d in devices if d.type == "cuda"}
    if getattr(pt, "in_place", False):
        for d in cards:
            pt.on(d)
        cards.add(pt.dev_csr_start.device)
    for d in cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_farmed(pipeline, target, pt, devices,
               make_worker_pipeline) -> None:
    """Run the query stage concurrently across the slots `devices`
    (resolved torch devices).

    `make_worker_pipeline(cfg, out, device) -> Pipeline` constructs a
    worker (passed in to avoid a circular import).  Raises whatever
    the first failing worker raised."""
    n = len(devices)
    cfg = pipeline.cfg
    writers = []
    workers = []
    errors = []
    _lock = threading.Lock()
    _share_table(pt, devices)

    def work(k: int):
        wcfg = copy.deepcopy(cfg)
        wcfg.shard_count = n
        wcfg.shard_index = k
        wcfg.stats_filename = None     # parent reports merged stats
        wout = writers[k]
        try:
            with on_slot(devices[k]):
                wpl = make_worker_pipeline(wcfg, wout, devices[k])
                wpl._farm_worker = True
                # pin every per-query device launch to this slot
                wpl._farm_cache = [devices[k]]
                wpl.run(target, pt)
            wout.end_queries()
            with _lock:
                pipeline.stats.merge(wpl.stats)
                pipeline._search_limit_exceeded += \
                    wpl._search_limit_exceeded
        except BaseException as e:      # noqa: BLE001 — re-raised
            errors.append(e)

    for k in range(n):
        writers.append(_ChunkWriter())
        t = threading.Thread(target=work, args=(k,), daemon=True,
                             name=f"lastz-torch-farm-{k}")
        workers.append(t)
        t.start()
    for t in workers:
        t.join()
    if errors:
        raise errors[0]

    # stitch per-query chunks back in stream order; query indices are
    # 1-based stream positions, owner = (index-1) % n
    indices = sorted(i for w in writers for i in w.chunks)
    for i in indices:
        pipeline.out.write("".join(writers[(i - 1) % n].chunks[i]))
    pipeline._farmed = True
