"""Multi-process execution: query sharding across torch.distributed
processes with collective census reduction and rank-0 output merge
(port of lastz_tpu/parallel/distributed.py).

The reference's only multi-process facility is the capsule farm-out:
N single-threaded processes over query shards sharing one mmap'd
target index, with per-shard outputs concatenated by the user
(reference capsule.c:6-15 + README farm-out recipe).  Here one process
per rank of a torch.distributed group:

  * every process builds (or capsule-loads) the target index and
    takes every n-th query (`--shard=i/n` semantics, pipeline.py);
  * census coverage counts are ALL-REDUCED across processes after the
    query loop so process 0 reports global coverage;
  * per-query output chunks are gathered to process 0 and stitched in
    stream order, byte-identical to a single-process run.

Dynamic masking (cross-query coupling through the position table) is
excluded, like the reference, whose farm-out recipe also cannot mask
dynamically across processes.

Activation: LASTZ_TORCH_DIST=1 in a process whose caller initialized
the group (torch.distributed.init_process_group, e.g. gloo over
tcp://localhost:<port>) before the run.  The collectives move host
data (int64 counts and the output's bytes): CPU tensors under gloo,
the rank's current card under NCCL.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from .farm import _ChunkWriter


def dist_enabled() -> bool:
    return os.environ.get("LASTZ_TORCH_DIST", "") not in ("", "0")


def process_count() -> int:
    """The group's world size, 1 without an initialized group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def dist_supported(pipeline) -> bool:
    """Whether this job can run query-sharded across processes with
    output byte-identical to the serial run.  Mirrors
    farm.farm_supported but ALLOWS census reporting (reduced
    collectively); dynamic masking stays excluded (cross-query
    coupling through the position table, masking.c:6-25)."""
    cfg = pipeline.cfg
    if cfg.shard_count > 1:
        return False
    if cfg.dynamic_masking > 0:
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


# -- collectives ------------------------------------------------------------


def _allgather(x: np.ndarray) -> np.ndarray:
    """(nproc, *x.shape) gather of equal-shaped arrays across the
    group, in x's dtype."""
    x = np.ascontiguousarray(x)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(x.reshape(-1)).to(dev)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out]).reshape(
        (len(out),) + x.shape)


def allgather_i64(x: np.ndarray) -> np.ndarray:
    """(nproc, *x.shape) int64 gather across the process group."""
    return _allgather(np.asarray(x, np.int64))


def allreduce_census_counts(count: np.ndarray) -> np.ndarray:
    """Sum per-process census coverage, saturating at the census
    dtype's max (masking.c bumps saturate per process; the global sum
    saturates once, which can only differ when true coverage exceeds
    the dtype ceiling)."""
    total = allgather_i64(count).sum(axis=0)
    maxv = np.iinfo(count.dtype).max
    return np.minimum(total, maxv).astype(count.dtype)


def gather_texts(text: str) -> list[str] | None:
    """Gather one string per process to process 0 (None elsewhere)."""
    data = np.frombuffer(text.encode(), np.uint8)
    lens = allgather_i64(np.int64(len(data)))
    cap = max(int(lens.max()), 1)
    pad = np.zeros(cap, np.uint8)
    pad[: len(data)] = data
    gathered = _allgather(pad)
    if dist.get_rank() != 0:
        return None
    return [bytes(gathered[i, : int(lens[i])]).decode()
            for i in range(gathered.shape[0])]


# -- the distributed query stage ---------------------------------------------


def run_distributed(pipeline, target, pt, make_worker_pipeline) -> None:
    """Run the query stage sharded across the process group.

    Every process runs a worker pipeline over its query shard, on its
    own device, into a _ChunkWriter; chunks are gathered to process 0,
    which writes them into the real output stream in query order.
    Census counts are all-reduced into the parent pipeline's census so
    the report (and LAV m-stanza) is global."""
    n = dist.get_world_size()
    pid = dist.get_rank()
    cfg = pipeline.cfg

    wcfg = copy.deepcopy(cfg)
    wcfg.shard_count = n
    wcfg.shard_index = pid
    wcfg.stats_filename = None
    wout = _ChunkWriter()
    wpl = make_worker_pipeline(wcfg, wout, pipeline.device)
    wpl._farm_worker = True
    wpl.run(target, pt)
    wout.end_queries()
    pipeline.stats.merge(wpl.stats)
    pipeline._search_limit_exceeded += wpl._search_limit_exceeded

    # census all-reduce across the processes
    if pipeline.targ_census is not None \
            and wpl.targ_census is not None:
        pipeline.targ_census.count[:] = allreduce_census_counts(
            wpl.targ_census.count)

    # output merge: JSON-encode this process's chunks, gather to 0
    mine = json.dumps({str(i): "".join(c)
                       for i, c in wout.chunks.items()})
    texts = gather_texts(mine)
    if texts is not None:
        merged = {}
        for t in texts:
            for k, v in json.loads(t).items():
                merged[int(k)] = v
        for i in sorted(merged):
            pipeline.out.write(merged[i])
    pipeline._farmed = True
