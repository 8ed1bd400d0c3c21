#!/usr/bin/env python3
"""Smoke run of lastz_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --parent DIR     # ... and DIR's port beside

Phases, one line each (any failure exits nonzero):
  1 toolchain  card name and power limit, torch / CUDA / nvcc versions,
               and the build of csrc/*.cu into lastz_tpu_torch/build/
               (one nvcc process per source, all at once)
  2 kernels    each kernel against its plain PyTorch version on the
               card, exactly, at its path's shapes: K1 (y-drop chunk,
               128 lanes x 1536 columns x 1024 rows, the five cases of
               tests/test_ydrop_pallas_exact.py and a wide band at the
               main path's y-drop, with and without link bytes), K1's
               mega launch (MEGA_SHAPE: 128 lanes, 8 blocks of 1024
               rows, lanes ending in their first chunk, after several
               or past the blocks; every output, with and without link
               bytes), K2 (x-drop scan, 2M hits, and XDROP_EDGES: n,
               drops and ties at its stage and chunk edges), K2's wide
               instantiation (2M hits at each of K2_WIDE's alphabets,
               XDROP_EDGES at 40 codes), the traceback walk
               (one mega launch, and walk_inputs' synthetic blocks at
               WALK_EDGE_CAPS), K3 and K3b (band 512 x 1024 rows,
               4,096 anchors of the 4 Mbp pair below, forward and
               reverse; each one's swept cells, the rows its early stop
               leaves, beside the live and grid cells, and K3b on its
               input cut at those rows), and the chain
               walk on CHAIN_EDGES in both modes; times each wrapper call (K1's with the zeroed
               allocation of its link buffer) next to its plain version
               with CUDA events, and works out its bound from the
               inputs it was timed on (and the walk's chain floor)
  index        the position table built on the card against the host
               build (12of19): the 4 Mbp target and an INDEX_BP target
               with lowercase and N runs; both times, the memory peak
  3 main       the default run `lastz_tpu_torch.cli t.fa q.fa --stats`
               on a 4 Mbp synthetic pair (bench.py's ensure_pair
               recipe, seed 42: 600 conserved 2-6 kbp segments at
               72-85% identity), with every launch counter reset
               before it and a CUDA event pair around each launch of
               K1 (its mega launch), K2, the walk and the chain walk
               (the table's main_path_ms), K2's consumed cells over its
               live walks in buckets, the walk's longest lane per
               launch, and the chunks each mega launch ran; requires
               launches of all four, one mega launch a call and no host
               read in the chunk loop, a DevicePositionTable never fetched
               to the host nor uploaded again, a nonzero device gapped
               share and the seed stage on the device only; runs the
               main path's mega call with the most chunks once more
               through the kernel (equal to the main path's outputs) and
               through ydrop_mega_plain on the card (every output, link
               bytes included), with the band census of its rows, the
               band cells, the bound and the chain floor of all the
               calls; then runs
               lastz_tpu's host path (a child process, the reference) on
               the same pair and requires byte-equal LAV; then runs the
               port's CLI once more from a copy of lastz_tpu_torch alone
               (a child process with jax and lastz_tpu blocked) and
               requires the same LAV (and with --parent, DIR's port the
               same way, its --stats timers beside this one's)
  modes        --recoverseeds, --word=20 (an overweight seed) and a
               capsule (--writecapsule by the port, --targetcapsule run
               twice in this process) on the same pair, every counter
               reset before each: LAV byte-equal to lastz_tpu's CLI, no
               "seed host searches", launches of K2 and of the chain
               walk in its mode, the capsule's DeviceIndex reused; then
               the chain walk against its plain version on the captured
               first launches of the main and recover paths, timed
               through its wrapper and alone (an event pair around the
               kernel)
  batched     --twins and a quantum query on the pair's target (the
               queries cut to TWINS_BP and QUANTUM_BP; the quantum
               query written by lastz_tpu_torch.tools.any_to_qdna),
               every counter reset before each: LAV byte-equal to
               lastz_tpu's CLI, K2
               launched through the batched search's device branch,
               neither host x-drop scan called, no rewind to the scalar
               search; then the wide path, batch_xdrop_device on a
               40-code alphabet, against the same call on CPU tensors
  farm         the query farm-out (parallel/farm.py): the pair's query
               cut into FARM_QUERIES queries, run by the port's CLI
               serially and over FARM_SLOTS = ["cuda:0", "cuda:0"] (two
               worker threads on the card) in turns, every counter
               reset before each: LAV byte-equal to the serial run and
               that to lastz_tpu's host CLI (a child process); each
               worker launched K1's mega launch, K2, the walk and the
               chain walk, all on one non-default stream of its own
               (the stream handle each C entry point was passed); the
               DevicePositionTable never fetched to the host, and no
               upload made twice on a worker's stream; with more than
               one card, the farm over every card too; then two
               processes of a gloo group on the card (LASTZ_TORCH_DIST)
               with rank 0's LAV equal to the serial run; and the
               --twins search over two workers on TWINS_FARM_BP of the
               query cut into TWINS_FARM_QUERIES queries, equal to its
               serial run, with K2 through the batched search's device
               branch on both workers' streams
  shard        the target-sharded tier (search/sharded_mesh.py,
               align/ydrop_sharded.py, parallel/mesh.py) on SHARDS
               shards, SHARD_SLOTS = ["cuda:0"] * 4 (one card a shard
               where there are four), every counter reset before each
               path: (a) the pair through the port's CLI with
               LASTZ_TORCH_SHARDS=4, unsharded and sharded in turns,
               each LAV byte-equal to phase 3's lastz_tpu LAV, K2 on
               every shard (its device ms a launch), no "seed host
               searches"; (b) the INDEX_BP target in 4 shards against a
               SHARD_QUERY_BP mutated query cut from it (12of19, no
               transition): the sharded search's hits equal the port's
               unsharded device search's, with the index build by
               shard and each slot's bytes against the whole target's;
               (c) ShardedTargetYDrop on (a)'s first mega batch of
               anchors, lane for lane equal to DeviceYDrop, K1's mega
               launch and the walk launched; (d) parallel/mesh.py's
               step (MESH_SHAPE, 256 lanes x 128 rows) on 4 slots, on
               1 and on CPU tensors, every output equal, K1's chunk
               entry and K2 launched; (e) with four cards, (a) one
               shard a card, no card holding the whole target
  4 extend     ops/ydrop_pallas.py's own path, with every counter
               reset before it: prepare_anchor_batch, then
               ydrop_extend_batch (K3) and ydrop_band_batch (K3b) on
               the same 4,096 anchors in both orientations; requires
               launches of both and results equal to phase 2's plain
               versions

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Nothing of JAX or of lastz_tpu is
imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter, defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PAIR_BP = 4_000_000
K1_SHAPE = dict(B=128, rows=1024, W=1536)
K2_HITS = 1 << 21
# one production mega launch: 64 anchors x 2 directions
TB_SHAPE = dict(Bh=64, W=1536, rows=1024, blocks=8, n=6000)
# the mega launch's check: the main path's geometry on a 10 kbp related
# pair, so that lanes end in their first chunk, after several, or run
# past the 8 blocks (8,192 rows)
MEGA_SHAPE = dict(Bh=64, W=1536, rows=1024, blocks=8, n=10_000)
# K2's wide instantiation: alphabets of 40 codes (its table in shared
# memory) and 256 (through the read-only cache), at K2_HITS hits
K2_WIDE = (40, 256)
# K3/K3b: ydrop_extend_batch's default geometry, anchors on the pair's
# conserved segments drawn from their own seed
K3_SHAPE = dict(band=512, max_rows=1024, anchors=4096, seed=3)
# (name, y_drop, divergence, trim_to_peak, tb_cap, chunks, seed): the
# five cases of tests/test_ydrop_pallas_exact.py:96-116, then the main
# path's y-drop (9400) and traceback cap, whose bands grow past 160
# columns, K1's narrow tile, over several of its 288-column tiles
K1_CASES = [
    ("basic", 3000, 0.12, True, 1 << 20, 1, 1),
    ("multi_chunk_resume", 4000, 0.08, True, 1 << 20, 3, 2),
    ("boundary_noytrim", 3000, 0.10, False, 1 << 20, 1, 3),
    ("truncation", 3000, 0.10, True, 600, 1, 4),
    ("high_divergence", 900, 0.45, True, 1 << 20, 1, 5),
    ("wide_band", 9400, 0.20, True, 80 << 20, 2, 6),
]
# the K1 cases timed: the kernel table's row, then the wide band
K1_TIMED = ("basic", "wide_band")
# the walk's edge cases: caps at the edges of its 8-step groups and its
# 64-row tiles and to the end of every walk (None), on blocks of (K, R1,
# W); W = 200 takes the kernel's byte loads, 256 and 1536 (the main
# path's window) its 16-byte loads
WALK_EDGE_CAPS = [1, 8, 9, 63, 64, 65, 129, None]
WALK_EDGE_GEOMETRY = [(4, 41, 200), (3, 97, 256), (8, 130, 1536)]
# K2's edge cases: n at the stage and chunk edges of csrc/xdrop_scan.cu
# (a first stage of 64 cells read 8 at a time, chunks of 32 x 8 cells),
# and at the 128-cell rows of the Pallas kernel; drops at them,
# best-score ties across them
XDROP_EDGES = ([f"n{v}" for v in (0, 1, 31, 32, 33, 63, 64, 65, 127, 128,
                                  129, 255, 256, 257)]
               + [f"drop_at_{v}" for v in (31, 32, 63, 128, 256)]
               + [f"tie_{v}" for v in (32, 128, 256)])
# the chain walk's edge cases (chain_edge_inputs): chains of one hit;
# chains of cap - 1 and cap hits, and one of cap + 1 (unconverged, the
# walk stops at cap + 1 as the lockstep loop does); HASH_INACTIVE heads;
# recover collisions, two true diagonals on one hash; a long dead-hit
# sentinel chain; a launch with no live hit; a random mixture; chain
# lengths at the kernel's tile edges (CHAIN_TILE_LENGTHS); and chains of
# about 50 hits with one far longer (long_tail)
CHAIN_EDGES = ["single", "cap_edges", "cap_over", "inactive_head",
               "collisions", "dead_tail", "empty", "mixed", "tile_edges",
               "long_tail"]
# tile_edges' chain lengths: at the edges of csrc/resolve_chains.cu's
# 16-hit staging rounds, of a warp's 32 lanes and of the 1024-hit tiles
# a warp stages its run of hits through, and the main path's longest
# (410)
CHAIN_TILE = 1024
CHAIN_TILE_LENGTHS = [1, 2, 15, 16, 17, 31, 32, 33, 63, 64,
                      CHAIN_TILE - 1, CHAIN_TILE, CHAIN_TILE + 1,
                      2 * CHAIN_TILE, 410]


# the index phase: a synthetic target the size of a human chromosome
# such as chr19 or chr20, with lowercase and N runs, indexed with the
# default 12of19 seed
INDEX_BP = 64_000_000


# The card's peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes per
# second, and int32 operations per second outside the tensor cores --
# 64 INT32 lanes on each of the 132 SMs at the 1980 MHz boost clock.
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
SMS = 132
INT32_OPS_PER_S = SMS * 64 * CLOCK_HZ
# The floor of a serial walk (beside, not instead of, the roofline
# bound): its longest lane's steps, each one dependent shared-memory
# step of about 30 cycles.
WALK_STEP_CYCLES = 30
# int32 operations a kernel needs per DP cell of the y-drop band these
# inputs need (per scanned cell for K2, per step for the walk):
#   K3/K3b: score lookup, diagonal add, D (2 sub, max), I (2 sub, max),
#           C (2 max), prune (sub, compare, select), best (compare,
#           2 selects) = 16
#   K1: the same 16 plus 4 to compose the link byte = 20
#   K2: score lookup, add, running max, drop compare, stop test = 5
#   traceback: byte load, 3 mask tests, 2 coordinate steps = 6
#   chain walk (per walked hit, simple mode): live test, compare, max,
#           select = 4
OPS_PER_CELL = {"ydrop_chunk": 20, "ydrop_mega": 20, "xdrop_scan": 5,
                "xdrop_scan_wide": 5, "ydrop_traceback": 6,
                "ydrop_wavefront": 16, "ydrop_band": 16, "resolve_chains": 4}
# The floor of a chain walk: its longest chain, one dependent step (a
# compare and a select on the carried extent) of about 8 cycles a hit.
CHAIN_STEP_CYCLES = 8
# The floor of K1's mega launch: its longest lane's rows, each at least
# the least row latency that kernel_bench.py --census measured on the
# main path's 4.3 M rows (the profile build's fastest row, four warps a
# lane; NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6).
ROW_MIN_CYCLES = 2683


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(name, n_bytes, cells):
    """(bound_ms, bound_by): the larger of the bytes over the memory
    rate and the operations over the int32 rate."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * cells * OPS_PER_CELL[name] / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_diff(a, b) -> int:
    import torch
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_toolchain():
    import torch
    from lastz_tpu_torch.kernels import build
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    t0 = time.monotonic()
    lib = build.library_path()
    build.load()
    say("toolchain", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc[-1], python=sys.version.split()[0],
        build_s=round(time.monotonic() - t0, 3),
        library=os.path.relpath(lib, ROOT))
    log = lib[:-3] + ".log"
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip(), flush=True)
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _k1_inputs(rng, B, rows, W, chunks, div):
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    from lastz_tpu_torch.ops.ydrop_exact import make_compact_alphabet
    n = rows * (chunks + 1) + W + 64
    sc = new_dna_score_set()
    alpha = np.frombuffer(b"ACGT", np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < div
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    code_map, subsmall = make_compact_alphabet([s1, s2], sc.sub)
    a_full = np.stack([code_map[s1[o:o + rows * chunks + 8]]
                       for o in rng.integers(0, 32, B)])
    b_full = np.stack([code_map[s2[o:o + rows * chunks + W + 8]]
                       for o in rng.integers(0, 32, B)])
    return sc, subsmall, a_full, b_full


def k1_setup(case, dev):
    """One K1_CASES entry at K1_SHAPE: (kw, fresh state, score table,
    windows), where windows(state, prev_off) gives the next chunk's
    argument tensors and its b_off, derived from the state as the JAX
    test does."""
    import torch
    from lastz_tpu_torch.ops.ydrop_exact import fresh_state_np
    _, y_drop, div, trim, tb_cap, chunks, seed = case
    B, rows, W = K1_SHAPE["B"], K1_SHAPE["rows"], K1_SHAPE["W"]
    rng = np.random.default_rng(seed)
    sc, subsmall, a_full, b_full = _k1_inputs(rng, B, rows, W, chunks, div)
    ge = int(sc.gap_extend)
    goe = int(sc.gap_open + sc.gap_extend)
    Ms = np.full(B, a_full.shape[1] - 2, np.int32)
    Ns = np.full(B, b_full.shape[1] - 2, np.int32)
    kw = dict(gap_e=ge, gap_oe=goe, y_drop=y_drop, lanes=W, rows=rows,
              alpha=16, trim_to_peak=trim, tb_cap=tb_cap)
    st_np, _ = fresh_state_np(Ns.astype(np.int64), ge, goe, y_drop, W, B)
    state = {k: torch.from_numpy(v).to(dev) for k, v in st_np.items()}

    def windows(state, prev_off):
        done = state["done"].cpu().numpy()
        row_base = state["row"].cpu().numpy().astype(np.int64) - 1
        b_off = np.where(done, prev_off,
                         state["LY"].cpu().numpy().astype(np.int64))
        shift = (b_off - prev_off).astype(np.int32)
        a_win = np.zeros((B, rows), np.int32)
        b_win = np.zeros((B, W), np.int32)
        for b in range(B):
            lo = int(row_base[b])
            src = a_full[b, lo: lo + rows]
            a_win[b, : len(src)] = src
            lo2 = int(b_off[b])
            if lo2 == 0:
                src = b_full[b, : W - 1]
                b_win[b, 1: 1 + len(src)] = src
            else:
                src = b_full[b, lo2 - 1: lo2 - 1 + W]
                b_win[b, : len(src)] = src
        args = tuple(torch.from_numpy(a).to(dev) for a in
                     (a_win, b_win, b_off.astype(np.int32), shift, Ms, Ns))
        return args, b_off

    return kw, state, torch.from_numpy(subsmall).to(dev), windows


def k1_ms(args, state, sub_t, kw):
    """CUDA-event ms of one K1 chunk through its wrapper, the zeroed
    allocation of its link buffer included."""
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_chunk
    return cuda_ms(lambda: ydrop_chunk(*args, state, sub_t, **kw), 5)


def k1_bytes(args, sub_t, state, st_out):
    """K1's bytes for its bound: each input read once, the state written
    once, and one link byte per band cell (the chunk's traceback bytes,
    tbp), the rest of the link buffer being the zeros it arrived with.
    Returns (bytes, band cells)."""
    cells = int((st_out["tbp"].long() - state["tbp"].long()).sum())
    return (nbytes(*args, sub_t, *state.values()) + nbytes(*st_out.values())
            + cells, cells)


def check_k1(dev):
    """K1 against ydrop_chunk_plain on K1_CASES, chunk by chunk, windows
    derived from the (asserted equal) state as the JAX test does; every
    state column and link byte, with and without link bytes.  Returns
    (max_abs_err, {case: (kernel ms, plain ms, bytes, cells)}) of the
    first chunk of each K1_TIMED case; its cells are the y-drop band's,
    the traceback bytes (tbp) the chunk used."""
    import torch
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_chunk
    from lastz_tpu_torch.ops.ydrop_exact import ydrop_chunk_plain
    B = K1_SHAPE["B"]
    err = 0
    times = {}
    for case in K1_CASES:
        name, chunks = case[0], case[5]
        kw, state, sub_t, windows = k1_setup(case, dev)
        prev_off = np.zeros(B, np.int64)
        n_chunks = 0
        for chunk in range(chunks):
            args, prev_off = windows(state, prev_off)
            st_k, tb_k = ydrop_chunk(*args, state, sub_t, **kw)
            # the score-only mode of the main path's continuation
            st_s, tb_s = ydrop_chunk(*args, state, sub_t, **kw,
                                     want_tb=False)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            st_p, tb_p = ydrop_chunk_plain(*args, state, sub_t, **kw)
            torch.cuda.synchronize()
            plain_ms = 1000 * (time.monotonic() - t0)
            if tb_s is not None:
                raise AssertionError("K1 score-only mode returned link bytes")
            for k in st_p:
                for mode, st in (("", st_k), (" score-only", st_s)):
                    e = max_abs_diff(st[k], st_p[k])
                    if e:
                        raise AssertionError(
                            f"K1{mode} {name} chunk {chunk}: state[{k}] "
                            f"differs by {e}")
            e = max_abs_diff(tb_k, tb_p)
            if e:
                raise AssertionError(f"K1 {name} chunk {chunk}: tb differs")
            if chunk == 0 and name in K1_TIMED:
                ms = k1_ms(args, state, sub_t, kw)
                n_bytes, cells = k1_bytes(args, sub_t, state, st_k)
                times[name] = (ms, plain_ms, n_bytes, cells)
            err = max(err, e)
            state = st_k
            n_chunks += 1
            if bool(state["done"].all()):
                break
        say("kernels", kernel="ydrop_chunk", case=name, chunks=n_chunks,
            rows_used_max=int(state["rows_used"].max()),
            done=int(state["done"].sum()), equal=True)
    for name in K1_TIMED[1:]:
        ms, plain_ms, n_bytes, cells = times[name]
        bound_ms, bound_by = bound("ydrop_chunk", n_bytes, cells)
        say("kernels", kernel="ydrop_chunk", case=name, ms=ms,
            plain_ms=plain_ms, bytes=n_bytes, cells=cells,
            bound_ms=bound_ms, bound_by=bound_by)
    return (err, *times[K1_TIMED[0]])


def _related_codes(rng, n, ident):
    alpha = np.frombuffer(b"ACGT", np.uint8)
    s1 = alpha[rng.integers(0, 4, n)]
    s2 = s1.copy()
    mut = rng.random(n) < (1 - ident)
    s2[mut] = alpha[rng.integers(0, 4, mut.sum())]
    return s1, s2


def walk_inputs(seed=0, B=16, K=4, R1=41, W=200):
    """Synthetic input of the traceback walk: random link bytes (half
    of them diagonal), K stacked blocks of R1 - 1 rows with random
    column origins, so that walks cross blocks and meet every clamp.
    Lane 0 is not wanted; lane 1 starts right of its block's window
    (lane clamp W - 1) and below its last row (local clamp R1 - 1);
    lane 2 reaches column 0 with rows left (col < 0) and lane 3 row 0
    with columns left (the row-0 insertion run).  Returns numpy
    (tb_all, row_lo, row_hi, col0, nblk, end1, end2, want)."""
    rng = np.random.default_rng(seed)
    cid = rng.choice(4, size=(B, K, R1, W), p=[0.5, 0.2, 0.2, 0.1])
    tb = (cid | (rng.integers(0, 4, cid.shape) << 2)).astype(np.uint8)
    nblk = rng.integers(1, K + 1, B).astype(np.int32)
    nblk[:4] = K
    kk = np.arange(K)[None, :]
    live = kk < nblk[:, None]
    row_lo = np.where(live, 1 + (R1 - 1) * kk, 0).astype(np.int32)
    row_hi = np.where(live, row_lo + R1 - 2, 0).astype(np.int32)
    col0 = np.where(live, rng.integers(0, 60, (B, K)), 0).astype(np.int32)
    last = nblk - 1
    end1 = (row_lo[np.arange(B), last]
            + rng.integers(0, R1 - 1, B)).astype(np.int32)
    end2 = (col0[np.arange(B), last]
            + rng.integers(0, W, B)).astype(np.int32)
    want = rng.random(B) < 0.9
    want[0] = False
    want[1:4] = True
    end1[1] = row_lo[1, -1] + R1 + 5
    end2[1] = col0[1, -1] + W + 7
    end1[2], end2[2] = (R1 - 1) * K - 3, 6
    end1[3], end2[3] = 5, W - 1
    return tb, row_lo, row_hi, col0, nblk, end1, end2, want


def _edge_walks(case, rng):
    """The walks of one XDROP_EDGES case as per-cell score lists and n,
    and the expected (consumed, best, kbest) of its first walk.  Cells
    right after n score -500 (a drop, were they read) and then +10."""
    up = [10] * 20
    kind, v = re.fullmatch(r"(\D+)(\d+)", case).groups()
    v = int(v)
    if kind == "n":   # runs to n, then the same with random steps
        walk = [10] * v + [-500] + up
        rnd = list(rng.choice([10, -10, 0], v)) + [-500] + up
        return [(walk, v), (rnd, v), (rnd, v + 1)], (v, 10 * v,
                                                     v - 1 if v else -1)
    if kind == "drop_at_":
        walk = [10] * v + [-500] + up * 15
        return [(walk, 300), (walk, v + 1), (walk, v)], (v + 1, 10 * v,
                                                         v - 1)
    # tie_: the best sum again one cell after a v-cell boundary
    walk = [10] * v + [-10, 10] + [-10] * 40
    return [(walk, 300), (walk, v + 2)], (v + 33, 10 * v, v - 1)


def xdrop_edge_inputs(case, K=4):
    """One XDROP_EDGES case on a K-code alphabet (uint8 codes past 16,
    K2's wide instantiation): each walk's scores are laid out from its
    hit on the diagonal, right from p and left from p - 1 alike, in the
    last four codes.  Returns numpy (seq1p, seq2p, subflat, pos1, pos2,
    n_l, n_r), x_drop and the first walk's expected (consumed, best,
    kbest)."""
    from lastz_tpu_torch.device import SEQ_PAD
    rng = np.random.default_rng(len(case) * 100 + sum(map(ord, case)))
    hits, expect = _edge_walks(case, rng)
    b = K - 4
    code = {10: b, -10: b + 1, -500: b + 2, 0: b + 3}
    dtype = np.uint8 if K > 16 else np.int8
    sub = rng.integers(-150, 100, (K, K)).astype(np.int32)
    sub[b, b:] = [10, -10, -500, 0]
    span = max(len(w) for w, _ in hits) + 8
    L = span * (2 * len(hits) + 1)
    s1 = rng.integers(0, K, L).astype(dtype)
    s2 = rng.integers(0, K, L).astype(dtype)
    pos = span * (2 * np.arange(len(hits)) + 1)
    for p, (walk, _) in zip(pos, hits):
        c = np.array([code[s] for s in walk], dtype)
        s1[p: p + len(c)] = b
        s2[p: p + len(c)] = c
        s1[p - len(c): p] = b
        s2[p - len(c): p] = c[::-1]
    pad = np.zeros(SEQ_PAD, dtype)
    n = np.array([m for _, m in hits], np.int32)
    return ((np.concatenate([pad, s1, pad]), np.concatenate([pad, s2, pad]),
             sub.reshape(-1), pos.astype(np.int32), pos.astype(np.int32), n,
             n), 300, expect)


def chain_edge_inputs(case, cap):
    """One CHAIN_EDGES case as a launch's hash-sorted hits: numpy
    (key_s, extent_s, start2_s, diag_s, live_s) per hit and the 64K
    states (de, da) the launch starts from; `cap` is the walk's chain
    cap.  Live hits are sorted by hash, each chain's start2 ascending
    (the query order a stable sort keeps), and the dead hits follow
    with key 65536."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n_dead = {"dead_tail": 5000, "empty": 1000}.get(case, 50)
    if case == "single":
        hashes = rng.choice(65536, 3000, replace=False)
        lens = np.ones(3000, np.int64)
    elif case == "cap_edges":
        hashes, lens = np.array([5, 900, 40000]), np.array([cap - 1, cap, 3])
    elif case == "cap_over":
        hashes, lens = np.array([17, 300]), np.array([cap + 1, 10])
    elif case == "empty":
        hashes, lens = np.zeros(0, np.int64), np.zeros(0, np.int64)
    elif case == "tile_edges":
        # four chains of each length at random hashes, then 40 chains
        # in a row (a warp's 32 and more) that each cross a tile edge
        edges = np.array(CHAIN_TILE_LENGTHS * 4)
        hashes = rng.choice(65536, len(edges) + 40, replace=False)
        lens = np.minimum(np.concatenate(
            [edges, np.full(40, CHAIN_TILE + 1)]), cap)
    elif case == "long_tail":
        # the main path's shape: chains of about 50 hits on every hash
        # and one far longer, still under the cap
        hashes = np.sort(rng.choice(65536, 16384, replace=False))
        lens = np.minimum(rng.poisson(50, 16384), cap)
        lens[rng.integers(16384)] = min(3000, cap)
    else:
        n = {"mixed": 2000}.get(case, 200)
        hashes = rng.choice(65536, n, replace=False)
        lens = np.minimum(rng.geometric(0.05, n), min(200, cap))
    order = np.argsort(hashes)
    hashes, lens = hashes[order], lens[order]
    live_n = int(lens.sum())
    key = np.concatenate([np.repeat(hashes, lens),
                          np.full(n_dead, 65536)]).astype(np.int32)
    live = key < 65536
    start2 = rng.integers(0, 1_000_000, key.shape[0])
    first = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    for f, m in zip(first, lens):
        start2[f: f + m] = np.sort(start2[f: f + m])
    extent = start2 + 19 + rng.integers(-5, 3000, key.shape[0])
    # a true diagonal with the hit's hash: h + 65536 k
    wrap = rng.integers(-2, 3, key.shape[0])
    if case == "collisions":
        wrap = rng.integers(0, 2, key.shape[0])  # two diagonals a hash
    diag = np.where(live, key + 65536 * wrap, rng.integers(-9, 9, key.shape))
    de = np.where(rng.random(65536) < 0.3, -1,
                  rng.integers(0, 1_000_000, 65536))
    da = np.arange(65536) + 65536 * rng.integers(-2, 3, 65536)
    if case == "inactive_head":
        de[hashes] = -1
    if case == "collisions":
        de[hashes] = rng.integers(0, 1_000_000, len(hashes))
        da[hashes] = hashes + 65536 * rng.integers(0, 2, len(hashes))
    assert live.sum() == live_n
    return tuple(a.astype(np.int32) for a in (key, extent, start2, diag)) \
        + (live, de.astype(np.int32), da.astype(np.int32))


def chain_walk_args(arrays, recover):
    """resolve_chains' arguments from chain_edge_inputs' arrays (numpy
    or tensors on one device), as hit_launch makes them."""
    import torch
    from lastz_tpu_torch.ops.hitgen import chain_bounds
    key, extent, start2, diag, live, de, da = (
        a if torch.is_tensor(a) else torch.from_numpy(a) for a in arrays)
    seg_start = torch.cat([key.new_ones(1, dtype=torch.bool),
                           key[1:] != key[:-1]])
    starts, lens = chain_bounds(seg_start, live)
    at = torch.clamp(key, max=65535).long()
    if recover:
        return (starts, lens, extent, start2, de[at], live, diag, da[at])
    return starts, lens, extent, start2, torch.clamp(de[at], min=0), live


def k2_setup(dev):
    """K2's table shape: the arguments of xdrop_scan for 2M hits of a
    4 Mbp pair, half on the conserved diagonal (long scans inside its
    segments), half random (short)."""
    import torch
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    from lastz_tpu_torch.device import carry_state
    rng = np.random.default_rng(7)
    n = PAIR_BP
    # unrelated background with a conserved 3 kbp segment (85%
    # identity) on diagonal 0 every 10 kbp, as in the main path's pair
    s1, s2 = _related_codes(rng, n, 0.85)
    bg = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    keep = (np.arange(n) % 10_000) < 3_000
    s2 = np.where(keep, s2, bg)
    state = carry_state(s1, s2, new_dna_score_set().sub, dev)
    H = K2_HITS
    pos1 = rng.integers(19, n, H)
    pos2 = np.where(rng.random(H) < 0.5, pos1,
                    rng.integers(19, n, H))
    diag = pos1 - pos2
    n_l = pos1 - np.maximum(diag, 0)
    n_r = np.maximum(np.minimum(n, n + diag) - pos1, 0)
    t = [torch.from_numpy(a.astype(np.int32)).to(dev)
         for a in (pos1, pos2, n_l, n_r)]
    subflat = state["subsmall_t"].reshape(-1)
    return (state["seq1p"], state["seq2p"], subflat, 16, *t, 910)


def k2_wide_setup(dev, K):
    """k2_setup's shape on a K-code alphabet (uint8 codes, K2's wide
    instantiation): a random pair of PAIR_BP codes, conserved (85%)
    3 kbp in every 10 kbp on diagonal 0, a K x K table with positive
    matches, and K2_HITS hits, half on that diagonal."""
    import torch
    from lastz_tpu_torch.device import SEQ_PAD
    rng = np.random.default_rng(K)
    n = PAIR_BP
    s1 = rng.integers(0, K, n).astype(np.uint8)
    s2 = np.where(rng.random(n) < 0.15, rng.integers(0, K, n), s1)
    s2 = np.where((np.arange(n) % 10_000) < 3_000, s2,
                  rng.integers(0, K, n)).astype(np.uint8)
    sub = rng.integers(-60, 20, (K, K)).astype(np.int32)
    sub[np.arange(K), np.arange(K)] = rng.integers(40, 100, K)
    H = K2_HITS
    pos1 = rng.integers(19, n, H)
    pos2 = np.where(rng.random(H) < 0.5, pos1, rng.integers(19, n, H))
    diag = pos1 - pos2
    n_l = pos1 - np.maximum(diag, 0)
    n_r = np.maximum(np.minimum(n, n + diag) - pos1, 0)
    pad = np.zeros(SEQ_PAD, np.uint8)
    t = [torch.from_numpy(a.astype(np.int32)).to(dev)
         for a in (pos1, pos2, n_l, n_r)]
    seqs = [torch.from_numpy(np.concatenate([pad, a, pad])).to(dev)
            for a in (s1, s2)]
    return (*seqs, torch.from_numpy(sub.reshape(-1)).to(dev), K, *t, 400)


def check_k2_wide(dev):
    """K2's wide instantiation against xdrop_scan_plain at K2_WIDE's
    alphabets (the row from the first) and on XDROP_EDGES at K = 40."""
    import torch
    from lastz_tpu_torch.ops.xdrop_cuda import xdrop_scan
    from lastz_tpu_torch.ops.hitgen import xdrop_scan_plain
    err = 0
    rows = {}
    for K in K2_WIDE:
        args = k2_wide_setup(dev, K)
        got = xdrop_scan(*args)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        s1, s2, subflat, _, p1, p2, nl, nr, xd = args
        ref = (xdrop_scan_plain(s1, s2, subflat, K, p1 - 1, p2 - 1, nl, xd,
                                -1),
               xdrop_scan_plain(s1, s2, subflat, K, p1, p2, nr, xd, +1))
        torch.cuda.synchronize()
        plain_ms = 1000 * (time.monotonic() - t0)
        err = max(err, same(got[0] + got[1], ref[0] + ref[1], f"K2 K={K}"))
        ms = cuda_ms(lambda: xdrop_scan(*args), 5)
        rows[K] = (ms, plain_ms, *k2_bytes(args, got))
        say("kernels", kernel="xdrop_scan_wide", K=K, hits=K2_HITS, ms=ms,
            plain_ms=plain_ms, cells=rows[K][3],
            mean_consumed_right=float(got[1][0].float().mean()), equal=True)
    err = max(err, check_k2_edges(dev, 40))
    ms, plain_ms, n_bytes, cells = rows[K2_WIDE[0]]
    extra = {f"K{K}": dict(zip(("ms", "plain_ms", "bytes", "cells"), r))
             for K, r in rows.items()}
    return err, ms, plain_ms, n_bytes, cells, extra


def k2_bytes(args, got):
    """K2's bytes (inputs and outputs once) and scanned cells."""
    cells = int(got[0][0].long().sum() + got[1][0].long().sum())
    return nbytes(*args[:3], *args[4:8], *got[0], *got[1]), cells


def same(got, want, what):
    """Max abs error of two tuples of tensors; raises unless 0."""
    err = 0
    for i, (a, b) in enumerate(zip(got, want)):
        e = max_abs_diff(a, b)
        if e:
            raise AssertionError(f"{what}: output {i} differs by {e}")
        err = max(err, e)
    return err


def check_k2_edges(dev, K=4):
    """K2 against its plain version on XDROP_EDGES, on a K-code
    alphabet."""
    import torch
    from lastz_tpu_torch.ops.xdrop_cuda import xdrop_scan
    err = 0
    for case in XDROP_EDGES:
        arrays, x_drop, expect = xdrop_edge_inputs(case, K)
        cpu = [torch.from_numpy(a) for a in arrays]
        on = [a.to(dev) for a in cpu]
        got = xdrop_scan(*on[:3], K, *on[3:], x_drop)
        want = xdrop_scan(*cpu[:3], K, *cpu[3:], x_drop)
        err = max(err, same([a.cpu() for a in got[0] + got[1]],
                            want[0] + want[1], f"K2 edge {case}"))
        for side in want:
            if tuple(int(a[0]) for a in side) != expect:
                raise AssertionError(f"K2 edge {case}: not {expect}")
    say("kernels", kernel="xdrop_scan" if K <= 16 else "xdrop_scan_wide",
        K=K, edge_cases=len(XDROP_EDGES), equal=True)
    return err


def check_k2(dev):
    """K2 against xdrop_scan_plain at k2_setup's shape and on the edge
    cases."""
    import torch
    from lastz_tpu_torch.ops.xdrop_cuda import xdrop_scan
    from lastz_tpu_torch.ops.hitgen import xdrop_scan_plain
    args = k2_setup(dev)
    got = xdrop_scan(*args)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    s1, s2, subflat, K, p1, p2, nl, nr, xd = args
    ref = (xdrop_scan_plain(s1, s2, subflat, K, p1 - 1, p2 - 1, nl, xd, -1),
           xdrop_scan_plain(s1, s2, subflat, K, p1, p2, nr, xd, +1))
    torch.cuda.synchronize()
    plain_ms = 1000 * (time.monotonic() - t0)
    err = same(got[0] + got[1], ref[0] + ref[1], "K2")
    err = max(err, check_k2_edges(dev))
    ms = cuda_ms(lambda: xdrop_scan(*args), 5)
    say("kernels", kernel="xdrop_scan", hits=K2_HITS,
        mean_consumed_right=float(got[1][0].float().mean()), equal=True)
    return (err, ms, plain_ms, *k2_bytes(args, got))


def mega_setup(dev, shape, seed):
    """The arguments and keywords of one production mega launch:
    shape's Bh anchors on a related pair of shape's n bp (85%
    identity), both directions, shape's blocks of rows over a W-column
    window, the main path's y-drop and traceback cap."""
    import torch
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    from lastz_tpu_torch.ops.ydrop_exact import (fresh_state_np,
                                                 make_compact_alphabet)
    rng = np.random.default_rng(seed)
    Bh, W, rows, blocks, n = (shape[k] for k in
                              ("Bh", "W", "rows", "blocks", "n"))
    s1, s2 = _related_codes(rng, n, 0.85)
    sc = new_dna_score_set()
    code_map, subsmall = make_compact_alphabet([s1, s2], sc.sub)
    ge = int(sc.gap_extend)
    goe = int(sc.gap_open + sc.gap_extend)
    a1 = rng.integers(n // 60, n - n // 60, Bh)
    A1 = np.concatenate([a1, a1]).astype(np.int32)
    REV = np.arange(2 * Bh) >= Bh
    M = np.where(REV, A1 + 1, n - (A1 + 1)).astype(np.int32)
    N = M.copy()
    st_np, _ = fresh_state_np(N.astype(np.int64), ge, goe, 9400, W, 2 * Bh)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    lo = T(np.zeros(2 * Bh, np.int32))
    hi = T(np.full(2 * Bh, n, np.int32))
    args = (T(code_map[s1].astype(np.int8)), T(code_map[s2].astype(np.int8)),
            T(A1), T(A1), lo, hi, lo, hi, T(REV), T(M), T(N),
            {k: T(v) for k, v in st_np.items()},
            T(np.zeros(2 * Bh, np.int32)), T(subsmall))
    kw = dict(gap_e=ge, gap_oe=goe, y_drop=9400, lanes=W, rows=rows,
              max_blocks=blocks, alpha=16, trim_to_peak=True,
              tb_cap=80 * 1024 * 1024)
    return args, kw


def walk_setup(dev):
    """The walk's table shape: the arguments of traceback_mega for one
    production mega launch (TB_SHAPE, 64 anchors on a related 6 kbp
    pair, both directions, 8 blocks of 1024 rows over a 1536-column
    window)."""
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_mega
    args, kw = mega_setup(dev, TB_SHAPE, 11)
    st, _, packed, tb_all, row_lo, row_hi, col0 = ydrop_mega(*args, **kw)
    cap = kw["max_blocks"] * kw["rows"] + kw["lanes"] + 512
    return (tb_all, row_lo, row_hi, col0, packed[12], st["end1"],
            st["end2"], st["done"], cap)


def mega_bytes(args, out):
    """The mega launch's bytes for its bound: each input read once,
    each output written once, one link byte per band cell (the tbp the
    lanes used; the rest of the link blocks is the zeros they arrived
    with).  Returns (bytes, band cells)."""
    state = args[11]
    cells = int((out[0]["tbp"].long() - state["tbp"].long()).sum())
    return (nbytes(*args[:11], *state.values(), args[12], args[13])
            + nbytes(*out[0].values(), out[1], out[2], *out[4:]) + cells,
            cells)


def check_mega(dev):
    """K1's mega launch against ydrop_mega_plain at MEGA_SHAPE, every
    output (state, prev_off, packed, every link byte of every block,
    row_lo, row_hi, col0), with link bytes and score only (the plain
    version's state does not depend on with_tb; its score-only tb_all
    is (B, 1, 1, 1) zeros).  Returns (max_abs_err, ms, plain ms, bytes,
    cells, extra)."""
    import torch
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_mega
    from lastz_tpu_torch.ops.ydrop_exact import ydrop_mega_plain
    args, kw = mega_setup(dev, MEGA_SHAPE, 13)
    got = ydrop_mega(*args, **kw)
    score_only = ydrop_mega(*args, **kw, with_tb=False)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want = ydrop_mega_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = 1000 * (time.monotonic() - t0)
    names = ("prev_off", "packed", "tb_all", "row_lo", "row_hi", "col0")
    B = args[2].shape[0]
    err = 0
    for mode, out, tb_want in (
            ("", got, want[3]),
            (" score-only", score_only,
             torch.zeros((B, 1, 1, 1), dtype=torch.uint8, device=dev))):
        for k in want[0]:
            e = max_abs_diff(out[0][k], want[0][k])
            if e:
                raise AssertionError(f"mega{mode}: state[{k}] differs by {e}")
        for name, a, b in zip(names, out[1:],
                              (want[1], want[2], tb_want, *want[4:])):
            e = max_abs_diff(a, b)
            if e:
                raise AssertionError(f"mega{mode}: {name} differs by {e}")
            err = max(err, e)
    ms = cuda_ms(lambda: ydrop_mega(*args, **kw), 3)
    score_ms = cuda_ms(lambda: ydrop_mega(*args, **kw, with_tb=False), 3)
    nblk = want[2][12].cpu()
    done = want[0]["done"].cpu()
    say("kernels", kernel="ydrop_mega", lanes=B, blocks=kw["max_blocks"],
        chunks=int(nblk.max()),
        lanes_by_chunks={int(k): int((nblk == k).sum())
                         for k in nblk.unique()},
        done=int(done.sum()), score_only_ms=score_ms, equal=True)
    if not (bool((done & (nblk == 1)).any()) and bool((~done).any())):
        raise AssertionError("mega: no lane ended in its first chunk, or "
                             "none ran past the blocks")
    return (err, ms, plain_ms, *mega_bytes(args, got),
            {"score_only_ms": score_ms, "chunks": int(nblk.max())})


def k1_warps() -> int:
    """The warps of a lane's CTA in csrc/ydrop_chunk.cu (its WARPS)."""
    with open(os.path.join(ROOT, "lastz_tpu_torch", "csrc",
                           "ydrop_chunk.cu")) as f:
        return int(re.search(r"constexpr int WARPS = (\d+);",
                             f.read()).group(1))


def row_floor_ms(rows):
    """The floor of a lane's chain of rows: ROW_MIN_CYCLES each."""
    return 1e3 * rows * ROW_MIN_CYCLES / CLOCK_HZ


def check_main_mega(calls, walk_floor, card):
    """The main path's mega calls (mega_capture): each lane's rows and
    the band cells, and the call with the most chunks once more through
    the kernel and through ydrop_mega_plain on the card, every output
    (its outputs but the link bytes also against the main path's own);
    the band census of that call from the plain version's rows.  Returns
    the mega row's main-path entries."""
    import torch
    from lastz_tpu_torch.ops import ydrop_exact as tx
    from lastz_tpu_torch.ops.ydrop_cuda import ydrop_mega
    if not calls:
        raise AssertionError("main path: no mega call was captured")
    chunks = [int(out[2][12].max()) for _, _, out in calls]
    rows = [tx.lane_rows(out[2][12].cpu().numpy(), out[3].cpu().numpy(),
                         out[4].cpu().numpy()) for _, _, out in calls]
    cells = sum(int((out[0]["tbp"].long() - args[11]["tbp"].long()).sum())
                for args, _, out in calls)
    i = int(np.argmax(chunks))
    args, kw, seen = calls[i]
    got = ydrop_mega(*args, **kw)
    for k in seen[0]:
        if not torch.equal(got[0][k], seen[0][k]):
            raise AssertionError(f"main mega call {i}: state[{k}] differs "
                                 f"from the main path's")
    for a, b in zip((*got[1:3], *got[4:]), seen[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"main mega call {i}: differs from the main "
                                 f"path's")
    bands = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want = tx.ydrop_mega_plain(*args, bands=bands, **kw)
    torch.cuda.synchronize()
    plain_ms = 1000 * (time.monotonic() - t0)
    err = 0
    for k in want[0]:
        e = max_abs_diff(got[0][k], want[0][k])
        if e:
            raise AssertionError(f"main mega call {i}: state[{k}] differs "
                                 f"from the plain version by {e}")
    for name, a, b in zip(("prev_off", "packed", "tb_all", "row_lo",
                           "row_hi", "col0"), got[1:], want[1:]):
        e = max_abs_diff(a, b)
        if e:
            raise AssertionError(f"main mega call {i}: {name} differs from "
                                 f"the plain version by {e}")
        err = max(err, e)
    census = tx.band_census(tx.lane_bands(bands))
    longest = [int(r.max()) for r in rows]
    floor = sum(row_floor_ms(m) for m in longest)
    bound_ms, bound_by = bound("ydrop_mega", 0, cells)
    say("main", kernel="ydrop_mega", captured_call=i, chunks=chunks[i],
        lanes=len(rows[i]), equal_to_plain=True, max_abs_err=err,
        plain_ms=plain_ms, band_census={
            "all": census["all"], "longest_lane": census["longest_lane"]},
        longest_lane_rows_per_call=longest,
        median_lane_rows_per_call=[float(np.median(r)) for r in rows],
        band_cells=cells, bound_ms=bound_ms, bound_by=bound_by,
        chain_floor_ms_total=floor, card=card)
    return dict(
        warps_per_lane=k1_warps(), main_path_max_abs_err=err,
        main_path_plain_ms=plain_ms, main_path_captured_chunks=chunks[i],
        main_path_longest_lane_rows=max(longest),
        main_path_longest_lane_rows_per_call=longest,
        main_path_band_census={
            k: census[k] for k in ("all", "longest_lane")},
        main_path_band_cells=cells, main_path_bound_ms=bound_ms,
        main_path_bound_by=bound_by,
        main_path_chain_floor_ms=floor,
        main_path_walk_chain_floor_ms=walk_floor)


def walk_bytes(args, got):
    """The walk's bytes and steps: it reads one link byte and writes one
    op byte per step (the rest of the link blocks is never read), and
    reads and writes the per-lane arrays once."""
    steps = int(got[1][args[7]].long().sum())
    return 2 * steps + nbytes(*args[1:8], got[0], *got[1:]), steps


def chain_floor_ms(max_steps):
    """The floor of a serial walk: its longest lane's steps, one
    dependent shared-memory step each (WALK_STEP_CYCLES)."""
    return 1e3 * max_steps * WALK_STEP_CYCLES / CLOCK_HZ


def check_walk_edges(dev):
    """The walk against its plain version on walk_inputs, at every
    WALK_EDGE_GEOMETRY and WALK_EDGE_CAPS."""
    import torch
    from lastz_tpu_torch.ops.ydrop_cuda import traceback_mega
    err = 0
    for K, R1, W in WALK_EDGE_GEOMETRY:
        cpu = [torch.from_numpy(a) for a in walk_inputs(1, K=K, R1=R1, W=W)]
        on = [a.to(dev) for a in cpu]
        for cap in WALK_EDGE_CAPS:
            cap = cap or K * R1 + W + 512
            got = traceback_mega(*on, cap)
            want = traceback_mega(*cpu, cap)
            err = max(err, same([a.cpu() for a in got], want,
                                f"walk edge {(K, R1, W)} cap {cap}"))
    say("kernels", kernel="ydrop_traceback",
        edge_cases=len(WALK_EDGE_GEOMETRY) * len(WALK_EDGE_CAPS), equal=True)
    return err


def check_traceback(dev):
    """The traceback kernel against traceback_mega_plain at walk_setup's
    shape and on the edge cases."""
    import torch
    from lastz_tpu_torch.ops.ydrop_cuda import traceback_mega
    from lastz_tpu_torch.ops.ydrop_exact import traceback_mega_plain
    args = walk_setup(dev)
    got = traceback_mega(*args)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = traceback_mega_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1000 * (time.monotonic() - t0)
    err = max(same(got, ref, "traceback"), check_walk_edges(dev))
    ms = cuda_ms(lambda: traceback_mega(*args), 3)
    max_steps = int(got[1].max())
    floor = chain_floor_ms(max_steps)
    say("kernels", kernel="ydrop_traceback", lanes=len(args[7]),
        walked=int(args[7].sum()), max_steps=max_steps,
        chain_floor_ms=floor, equal=True)
    return (err, ms, plain_ms, *walk_bytes(args, got),
            {"chain_floor_ms": floor})


def check_chain_edges(dev):
    """The chain walk against its plain version on CHAIN_EDGES, both
    modes, at the real chain cap."""
    from lastz_tpu_torch.ops.hitgen import RESOLVE_CHAIN_CAP
    from lastz_tpu_torch.ops.resolve_cuda import resolve_chains
    err = 0
    for case in CHAIN_EDGES:
        arrays = chain_edge_inputs(case, RESOLVE_CHAIN_CAP)
        for recover in (False, True):
            what = f"chain walk {case} recover={recover}"
            cpu = chain_walk_args(arrays, recover)
            got = resolve_chains(*(a.to(dev) for a in cpu))
            want = resolve_chains(*cpu)
            if got[-1] != want[-1]:
                raise AssertionError(f"{what}: converged differs")
            err = max(err, same([a.cpu() for a in got[:-1]], want[:-1], what))
    say("kernels", kernel="resolve_chains", edge_cases=2 * len(CHAIN_EDGES),
        equal=True)
    return err


def chain_walk_floor_ms(max_len):
    """The floor of a chain walk: its longest chain's hits, one dependent
    step (CHAIN_STEP_CYCLES) each."""
    return 1e3 * max_len * CHAIN_STEP_CYCLES / CLOCK_HZ


def check_chain_launch(launch):
    """The chain walk against its plain version on the card, on one
    launch's arguments captured from a path (chain_capture); returns
    (max_abs_err, kernel ms, plain ms, bytes, walked hits, extra)."""
    import torch
    from lastz_tpu_torch.ops import hitgen
    from lastz_tpu_torch.ops.resolve_cuda import resolve_chains
    a, kw = launch
    recover = "diag_s" in kw
    starts, lens, extent, start2, de0, live = a
    got = resolve_chains(*a, **kw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    if recover:
        want = hitgen._resolve_chains_recover(extent, start2, kw["diag_s"],
                                              de0, kw["da0_s"], starts, lens,
                                              live)
    else:
        want = hitgen._resolve_chains(extent, start2, de0, starts, lens, live)
    torch.cuda.synchronize()
    plain_ms = 1000 * (time.monotonic() - t0)
    if got[-1] != want[-1]:
        raise AssertionError(f"chain walk recover={recover}: converged "
                             f"differs")
    err = same(got[:-1], want[:-1], f"chain walk, a launch, recover={recover}")
    ms = cuda_ms(lambda: resolve_chains(*a, **kw), 5)
    kernel_ms = replay_ms("resolve_chains_launch",
                          lambda: resolve_chains(*a, **kw))
    n_bytes, walked, max_len = chain_bytes(launch)
    floor = chain_walk_floor_ms(max_len)
    say("kernels", kernel="resolve_chains", recover=recover,
        hits=extent.shape[0], walked=walked,
        chains=int((lens > 0).sum()), max_chain=max_len, ms=ms,
        kernel_ms=kernel_ms, plain_ms=plain_ms, chain_floor_ms=floor,
        equal=True)
    return err, ms, plain_ms, n_bytes, walked, {
        "max_chain": max_len, "chain_floor_ms": floor,
        "kernel_ms": kernel_ms}


def chain_bytes(launch):
    """(bytes, walked hits, longest walk) of one chain-walk launch:
    read, each walked hit's extent, start2 and live byte (recover: its
    diag too), each chain's start, length and head state(s); written,
    every hit's alive byte and de_before (recover: each chain's
    pair)."""
    import torch
    from lastz_tpu_torch.ops import hitgen
    (starts, lens, extent, *_), kw = launch
    recover = "diag_s" in kw
    walk = torch.clamp(lens.long(), max=hitgen.RESOLVE_CHAIN_CAP + 1)
    walked = int(walk.sum())
    n_bytes = (walked * (9 + 4 * recover) + extent.shape[0] * 5
               + starts.shape[0] * (12 + 12 * recover))
    return n_bytes, walked, int(walk.max())


def anchor_batches(pair):
    """K3_SHAPE's anchors, points on the pair's conserved segments, as
    prepare_anchor_batch gives them in both orientations: {reversed_:
    (codes1, codes2, sub4, params)} in numpy."""
    from lastz_tpu_torch.core.encoding import UPPER_NUC_TO_BITS
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    from lastz_tpu_torch.ops.ydrop_pallas import prepare_anchor_batch
    t, q, segs = pair
    rng = np.random.default_rng(K3_SHAPE["seed"])
    pick = rng.integers(0, len(segs), K3_SHAPE["anchors"])
    frac = rng.uniform(0.1, 0.9, K3_SHAPE["anchors"])
    anchors = [(p + int(f * lt), o + int(f * lq))
               for (p, o, lt, lq), f in zip((segs[i] for i in pick), frac)]
    sc = new_dna_score_set()
    v1 = UPPER_NUC_TO_BITS[t]
    v2 = UPPER_NUC_TO_BITS[q]
    sub4 = sc.dna4.astype(np.int32)
    ge, goe = int(sc.gap_extend), int(sc.gap_open + sc.gap_extend)
    y_drop = int(sc.gap_open) + 300 * ge  # LASTZ's default y-drop
    out = {}
    for rev in (False, True):
        c1, c2, params = prepare_anchor_batch(
            v1, v2, anchors, ge, goe, y_drop, band=K3_SHAPE["band"],
            max_rows=K3_SHAPE["max_rows"], reversed_=rev)
        out[rev] = (c1, c2, sub4, params)
    return out


def cut_codes(codes1, rows, fill=-1):
    """codes1 (B, max_rows) with `fill` from each anchor's rows[b] on:
    the input cut at an early stop's rows."""
    import torch
    keep = torch.arange(codes1.shape[1], device=codes1.device)[None, :] \
        < rows.to(codes1.device)[:, None]
    return torch.where(keep, codes1, fill).to(torch.int32).contiguous()


def check_k3(dev, batches, name):
    """K3 (name "ydrop_wavefront") or K3b ("ydrop_band") against its
    plain version on both orientations; returns (max_abs_err, kernel
    ms, plain ms, bytes, cells) of the forward batch, and each
    orientation's plain result.  Its cells are the band the y-drop
    needs, as the plain version counts them: per DP row, the columns
    from its first to its last cell that survives the prune."""
    import torch
    from lastz_tpu_torch.ops import ydrop_pallas as tp
    fn, plain = {"ydrop_wavefront": (tp.ydrop_extend_batch,
                                     tp.ydrop_wavefront_plain),
                 "ydrop_band": (tp.ydrop_band_batch,
                                tp.ydrop_band_plain)}[name]
    geo = dict(band=K3_SHAPE["band"], max_rows=K3_SHAPE["max_rows"])
    err = 0
    refs = {}
    for rev in (False, True):
        args = [torch.from_numpy(a).to(dev) for a in batches[rev]]
        got = fn(*args, **geo)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ref = plain(*args, **geo)
        torch.cuda.synchronize()
        p_ms = 1000 * (time.monotonic() - t0)
        e = max_abs_diff(got, ref)
        if e:
            raise AssertionError(f"{name} reversed={rev} differs by {e}")
        err = max(err, e)
        refs[rev] = ref
        say("kernels", kernel=name, reversed=rev, anchors=len(got),
            best_mean=float(got[:, 0].float().mean()),
            end_row_max=int(got[:, 1].max()), equal=True)
        if not rev:
            ms = cuda_ms(lambda: fn(*args, **geo), 3)
            plain_ms = p_ms
            again, span = plain(*args, **geo, live_span=True)
            if max_abs_diff(again, ref):
                raise AssertionError(f"{name}: live_span changed the result")
            cells = int(span.sum())
            grid = int(((args[0] >= 0).sum(1).long()
                        * (args[1] >= 0).sum(1).long()).sum())
            extra = {}
            if name == "ydrop_wavefront":
                # the rows K3's early stop leaves it, a full band each
                rows = tp.ydrop_wavefront_rows(*args, **geo)
                extra["swept_cells"] = int(rows.sum()) * geo["band"]
            else:
                # the rows K3b's early stop leaves it; past them codes1
                # may hold anything: the kernel on the cut input agrees
                rows = tp.ydrop_band_rows(*args, **geo)
                extra["swept_cells"] = int(rows.sum()) * geo["band"]
                cut = cut_codes(args[0], rows)
                if max_abs_diff(fn(cut, *args[1:], **geo), got):
                    raise AssertionError(f"{name}: the input cut at its "
                                         f"stop rows changed the result")
            say("kernels", kernel=name, live_cells=cells, grid_cells=grid,
                **extra)
            n_bytes = nbytes(*args, got)
    return err, ms, plain_ms, n_bytes, cells, {"refs": refs, **extra}


def phase_kernels(card, pair):
    """Returns the kernel rows and the plain K3/K3b results."""
    import torch
    dev = torch.device("cuda")
    batches = anchor_batches(pair)
    refs = {}
    rows = []
    for name, run, src, repl in (
            ("ydrop_chunk", lambda: check_k1(dev),
             "lastz_tpu_torch/csrc/ydrop_chunk.cu",
             "lastz_tpu/ops/ydrop_pallas_exact.py:79"),
            ("ydrop_mega", lambda: check_mega(dev),
             "lastz_tpu_torch/csrc/ydrop_chunk.cu",
             "lastz_tpu/ops/ydrop_pallas_exact.py:434"),
            ("xdrop_scan", lambda: check_k2(dev),
             "lastz_tpu_torch/csrc/xdrop_scan.cu",
             "lastz_tpu/ops/xdrop_pallas.py:91"),
            ("xdrop_scan_wide", lambda: check_k2_wide(dev),
             "lastz_tpu_torch/csrc/xdrop_scan.cu",
             "lastz_tpu/ops/xdrop_batch.py:199"),
            ("ydrop_traceback", lambda: check_traceback(dev),
             "lastz_tpu_torch/csrc/ydrop_traceback.cu",
             "lastz_tpu/ops/ydrop_exact.py:675"),
            ("ydrop_wavefront",
             lambda: check_k3(dev, batches, "ydrop_wavefront"),
             "lastz_tpu_torch/csrc/ydrop_wavefront.cu",
             "lastz_tpu/ops/ydrop_pallas.py:156"),
            ("ydrop_band", lambda: check_k3(dev, batches, "ydrop_band"),
             "lastz_tpu_torch/csrc/ydrop_wavefront.cu",
             "lastz_tpu/ops/ydrop_pallas.py:38")):
        err, ms, plain_ms, n_bytes, cells, *more = run()
        extra = more[0] if more else {}
        if "refs" in extra:
            refs[name] = extra.pop("refs")
        rows.append(kernel_row(card, name, src, repl, err, ms, plain_ms,
                               n_bytes, cells, extra))
    # the chain walk's edge cases now; its row, on launches of the main
    # and recover paths, after those paths (chain_row)
    chain_err = check_chain_edges(dev)
    return rows, refs, chain_err


def kernel_row(card, name, src, repl, err, ms, plain_ms, n_bytes, cells,
               extra):
    """One kernel's entry of the kernels line, printed as it is made."""
    bound_ms, bound_by = bound(name, n_bytes, cells)
    say("kernels", kernel=name, tolerance=0, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bytes=n_bytes, cells=cells, bound_ms=bound_ms,
        bound_by=bound_by, card=card)
    # no single PyTorch call computes any of these functions
    return dict(name=name, route="cuda", source=src, replaces=repl,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, **extra)


def chain_row(card, edge_err, main_launch, recover_launch):
    """The chain walk's entry: timed on a main-path launch (simple mode),
    and held against its plain version on it, on a recover-path launch
    and on the edge cases."""
    err, ms, plain_ms, n_bytes, walked, extra = check_chain_launch(
        main_launch)
    r_err, r_ms, r_plain, *_, r_extra = check_chain_launch(recover_launch)
    extra.update(recover_ms=r_ms, recover_plain_ms=r_plain,
                 recover_kernel_ms=r_extra["kernel_ms"],
                 recover_max_chain=r_extra["max_chain"])
    return kernel_row(card, "resolve_chains",
                      "lastz_tpu_torch/csrc/resolve_chains.cu",
                      "lastz_tpu/ops/hitgen.py:345",
                      max(err, r_err, edge_err), ms, plain_ms, n_bytes,
                      walked, extra)


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _write_fasta(path, name, s):
    with open(path, "w") as f:
        f.write(">" + name + "\n")
        for i in range(0, len(s), 80):
            f.write(bytes(s[i:i + 80]).decode() + "\n")


def make_pair():
    """bench.py's ensure_pair recipe (seed 42): conserved 2-6 kbp
    segments at 72-85% identity scattered through random background.
    Returns (target, query, segments) with one (target start, query
    start, target length, query length) per conserved segment."""
    rng = np.random.default_rng(42)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = PAIR_BP
    t = alpha[rng.integers(0, 4, n)]

    def mutate(seg, ident):
        out = []
        i = 0
        m = len(seg)
        while i < m:
            r = rng.random()
            if r < 0.01:
                out.append(alpha[rng.integers(0, 4)])
            elif r < 0.02:
                i += 1
            else:
                if rng.random() < (1 - ident):
                    out.append(alpha[rng.integers(0, 4)])
                else:
                    out.append(seg[i])
                i += 1
        return np.array(out, dtype=np.uint8)

    q_parts = []
    segs = []
    q_len = 0
    for _ in range(150 * (n // 1_000_000)):
        L = int(rng.integers(2000, 6000))
        p = int(rng.integers(0, n - L))
        f = int(rng.integers(1000, 5000))
        q_parts.append(alpha[rng.integers(0, 4, f)])
        ident = 0.72 + 0.13 * rng.random()
        q_parts.append(mutate(t[p:p + L], ident))
        segs.append((p, q_len + f, L, len(q_parts[-1])))
        q_len += f + len(q_parts[-1])
    return t, np.concatenate(q_parts), segs


def write_pair(tdir, pair):
    t, q, _ = pair
    tp = os.path.join(tdir, "t.fa")
    qp = os.path.join(tdir, "q.fa")
    _write_fasta(tp, "t", t)
    _write_fasta(qp, "q", q)
    return tp, qp, len(t), len(q)


def counters():
    """Every kernel wrapper of the port, by kernel name."""
    from lastz_tpu_torch.ops import (resolve_cuda, xdrop_cuda, ydrop_cuda,
                                     ydrop_pallas)
    return {"ydrop_chunk": ydrop_cuda.ydrop_chunk,
            "ydrop_mega": ydrop_cuda.ydrop_mega,
            "xdrop_scan": xdrop_cuda.xdrop_scan,
            "ydrop_traceback": ydrop_cuda.traceback_mega,
            "ydrop_wavefront": ydrop_pallas.ydrop_extend_batch,
            "ydrop_band": ydrop_pallas.ydrop_band_batch,
            "resolve_chains": resolve_cuda.resolve_chains}


def reset_counts():
    from lastz_tpu_torch.ops import resolve_cuda, xdrop_cuda, ydrop_exact
    for fn in counters().values():
        fn.launches = 0
    resolve_cuda.resolve_chains.recover_launches = 0
    xdrop_cuda.xdrop_scan.wide_launches = 0
    ydrop_exact.ydrop_mega_plain.host_reads = 0


def read_counts():
    """Each kernel's launches; resolve_chains_recover counts those of
    resolve_chains in recover mode, xdrop_scan_wide those of K2's wide
    instantiation, and ydrop_mega_host_reads the host's any() reads of
    the plain chunk loop (none where the mega launch runs)."""
    from lastz_tpu_torch.ops import resolve_cuda, xdrop_cuda, ydrop_exact
    return dict({k: fn.launches for k, fn in counters().items()},
                resolve_chains_recover=(
                    resolve_cuda.resolve_chains.recover_launches),
                xdrop_scan_wide=xdrop_cuda.xdrop_scan.wide_launches,
                ydrop_mega_host_reads=(
                    ydrop_exact.ydrop_mega_plain.host_reads))


@contextlib.contextmanager
def timed_launches(entry="ydrop_chunk_launch", fn=None):
    """A CUDA event pair around every call of the kernel library's
    `entry` inside the block, made through `fn` in its place when one is
    given; yields the list of (start, end) events."""
    import torch
    from lastz_tpu_torch.kernels import build
    lib = build.load()
    own = getattr(lib, entry)
    call = fn or own
    events = []

    def timed(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        rc = call(*a)
        e1.record()
        events.append((e0, e1))
        return rc

    setattr(lib, entry, timed)
    try:
        yield events
    finally:
        setattr(lib, entry, own)


def replay_ms(entry, call, reps: int = 20) -> float:
    """Device ms of one launch of the kernel library's `entry`: call()
    launches it once (through its wrapper), and its C arguments are then
    launched `reps` times back to back between two events, so the card
    never waits on the host (an event pair around one wrapper call also
    holds the host's enqueue when the card is idle)."""
    import torch
    from lastz_tpu_torch.kernels import build
    lib = build.load()
    own = getattr(lib, entry)
    seen = []

    def keep(*a):
        seen.append(a)
        return own(*a)

    setattr(lib, entry, keep)
    try:
        call()
    finally:
        setattr(lib, entry, own)
    a = seen[0]
    own(*a)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        build.check(own(*a), entry)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launch_ms(events):
    """Per-launch device ms of timed_launches' events (synchronizes)."""
    import torch
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in events])
    return dict(launches=len(ms), total_ms=float(ms.sum()),
                mean_ms=float(ms.mean()), median_ms=float(np.median(ms)),
                min_ms=float(ms.min()), max_ms=float(ms.max()))


# the main path's kernels, by the C entry point each one launches (K1
# through its mega launch)
MAIN_ENTRIES = {"ydrop_mega": "ydrop_mega_launch",
                "xdrop_scan": "xdrop_scan_launch",
                "ydrop_traceback": "ydrop_traceback_launch",
                "resolve_chains": "resolve_chains_launch"}
# upper edges of the buckets of K2's consumed cells on the main path
CONSUMED_BUCKETS = (32, 64, 256)


class _Seen:
    """A kernel wrapper's stand-in: calls it, then see(args, kwargs,
    result).  Its other attributes are the wrapper's own, read and set
    through it: a wrapper bumps its counts through its module's name
    for it, which is this stand-in while it is in place."""

    def __init__(self, own, see):
        object.__setattr__(self, "own", own)
        object.__setattr__(self, "see", see)

    def __call__(self, *a, **kw):
        out = self.own(*a, **kw)
        self.see(a, kw, out)
        return out

    def __getattr__(self, name):
        return getattr(self.own, name)

    def __setattr__(self, name, value):
        setattr(self.own, name, value)


@contextlib.contextmanager
def observed(module, name, see):
    """Calls see(args, kwargs, result) after every call of module.name
    inside the block."""
    own = getattr(module, name)
    setattr(module, name, _Seen(own, see))
    try:
        yield
    finally:
        setattr(module, name, own)


@contextlib.contextmanager
def main_path_probes():
    """Around the main path's run: a CUDA event pair around every launch
    of its kernels, the histogram of K2's consumed cells over its live
    walks (n > 0) by direction, the walk's longest wanted lane in each
    launch, and the chunks each mega call ran (its largest nblk).
    Yields the dict that main_path_report reads."""
    import torch
    from lastz_tpu_torch.align import ydrop_device
    from lastz_tpu_torch.ops import xdrop_cuda
    probes = {"hist": [], "walk_max": [], "mega_chunks": []}

    def see_k2(a, kw, out):
        rows = []
        for n, (consumed, _, _) in zip(a[6:8], out):
            c = consumed[n > 0]
            lo = 0
            row = []
            for hi in CONSUMED_BUCKETS:
                row.append(((c > lo) & (c <= hi)).sum())
                lo = hi
            row.append((c > lo).sum())
            rows.append(torch.stack(row))
        probes["hist"].append(torch.stack(rows))

    def see_walk(a, kw, out):
        probes["walk_max"].append(torch.where(a[7], out[1], 0).max())

    def see_mega(a, kw, out):
        probes["mega_chunks"].append(out[2][12].max())

    with contextlib.ExitStack() as stack:
        for name, entry in MAIN_ENTRIES.items():
            probes[name] = stack.enter_context(timed_launches(entry))
        stack.enter_context(observed(xdrop_cuda, "xdrop_scan", see_k2))
        stack.enter_context(observed(ydrop_device, "traceback_mega",
                                     see_walk))
        stack.enter_context(observed(ydrop_device, "ydrop_mega", see_mega))
        probes["chain_launch"] = stack.enter_context(chain_capture())
        yield probes


@contextlib.contextmanager
def chain_capture():
    """Keeps the arguments of the first chain-walk launch inside the
    block; yields the list that holds them as (args, kwargs)."""
    from lastz_tpu_torch.ops import resolve_cuda
    first = []

    def see(a, kw, out):
        if not first:
            first.append((a, kw))
    with observed(resolve_cuda, "resolve_chains", see):
        yield first


@contextlib.contextmanager
def mega_capture():
    """Keeps every mega call of the gapped stage inside the block: a copy
    of its arguments, its keywords, and its outputs but the link bytes
    (a block of them is 1.6 GB at 128 lanes); yields the list of (args,
    kwargs, outputs)."""
    import torch
    from lastz_tpu_torch.align import ydrop_device
    calls = []

    def copy(a):
        if isinstance(a, dict):
            return {k: v.clone() for k, v in a.items()}
        return a.clone() if torch.is_tensor(a) else a

    def see(a, kw, out):
        calls.append(([a[0], a[1], *map(copy, a[2:])], dict(kw),
                      (out[0], *out[1:3], *out[4:])))
    with observed(ydrop_device, "ydrop_mega", see):
        yield calls


@contextlib.contextmanager
def table_watch():
    """Around a pipeline run: the position tables its device build made
    (yielded list), with DevicePositionTable's host-fetch count at 0
    before it."""
    import lastz_tpu_torch.pipeline as tpipe
    from lastz_tpu_torch.index.postable import DevicePositionTable
    DevicePositionTable.host_fetches = 0
    built = []
    with observed(tpipe, "build_seed_position_table_device",
                  lambda a, kw, out: built.append(out)):
        yield built


def require_in_place(built, what):
    """The run built one DevicePositionTable and never fetched it."""
    from lastz_tpu_torch.index.postable import DevicePositionTable
    if len(built) != 1 or not isinstance(built[0], DevicePositionTable):
        raise AssertionError(f"{what}: no DevicePositionTable was built")
    if DevicePositionTable.host_fetches:
        raise AssertionError(f"{what}: the device table was fetched to the "
                             f"host {DevicePositionTable.host_fetches} times")


def main_path_report(probes, launches, card):
    """Prints what main_path_probes saw; returns each kernel's mean
    device ms a launch and the walk's summed chain floor."""
    import torch
    mean_ms = {}
    for name in MAIN_ENTRIES:
        ms = launch_ms(probes[name])
        if ms["launches"] != launches[name]:
            raise AssertionError(f"{name}'s timed calls and launches differ")
        say("main", kernel=name, device_ms_per_launch=ms, card=card)
        mean_ms[name] = ms["mean_ms"]
    hist = torch.stack(probes["hist"]).sum(0).cpu().tolist()
    names = [f"<={b}" for b in CONSUMED_BUCKETS] + [
        f">{CONSUMED_BUCKETS[-1]}"]
    say("main", kernel="xdrop_scan", consumed_cells_of_live_walks={
        side: dict(zip(names, row)) for side, row in
        (("left", hist[0]), ("right", hist[1]),
         ("both", [a + b for a, b in zip(*hist)]))})
    walk_max = [int(m) for m in probes["walk_max"]]
    floor = sum(chain_floor_ms(m) for m in walk_max)
    say("main", kernel="ydrop_traceback", max_steps=max(walk_max),
        max_steps_per_launch=walk_max, chain_floor_ms_total=floor,
        chain_floor_ms_per_launch=floor / len(walk_max), card=card)
    chunks = [int(c) for c in probes["mega_chunks"]]
    mega = launch_ms(probes["ydrop_mega"])
    say("main", kernel="ydrop_mega", mega_calls=len(chunks),
        mega_launches=launches["ydrop_mega"], chunks_run=sum(chunks),
        chunks_per_call=chunks,
        host_any_reads_in_chunk_loop=launches["ydrop_mega_host_reads"],
        chunk_entry_launches=launches["ydrop_chunk"],
        k1_device_ms=mega["total_ms"],
        k1_device_ms_per_chunk=mega["total_ms"] / max(sum(chunks), 1),
        card=card)
    if launches["ydrop_mega"] != len(chunks):
        raise AssertionError("main path: K1's mega launches differ from the "
                             "mega calls")
    if launches["ydrop_mega_host_reads"] or launches["ydrop_chunk"]:
        raise AssertionError("main path: the gapped stage ran the host "
                             "loop of chunks")
    mean_ms["ydrop_chunk"] = mega["total_ms"] / max(sum(chunks), 1)
    return mean_ms, floor


def require_launched(launches, path):
    """Fails when a kernel of the path just driven was not launched."""
    for k in path:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on its path")


# the port's CLI with neither JAX nor lastz_tpu importable, run
# sys.argv[2] times in one process (the output of the last run kept);
# the card's context and the kernel library are made before the first,
# so that no timer of a job holds them
_ALONE = r"""
import contextlib, io, sys
sys.modules["jax"] = None
sys.modules["lastz_tpu"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.zeros(1, device="cuda")
from lastz_tpu_torch import cli
from lastz_tpu_torch.kernels import build
build.load()
for _ in range(int(sys.argv[2]) - 1):
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(sys.argv[3:]) == 0
rc = cli.main(sys.argv[3:])
assert not any(m == "lastz_tpu" or m.startswith("lastz_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
sys.exit(rc)
"""


def stats_timers(text):
    """The last `wall clock:` section of --stats output, {bucket:
    seconds}."""
    timers = {}
    on = False
    for line in text.splitlines():
        if line.startswith("wall clock:"):
            on = True
            timers = {}
        elif on:
            m = re.fullmatch(r"\s*(.+?): ([0-9.]+)s", line)
            if m:
                timers[m.group(1)] = float(m.group(2))
            on = bool(m)
    return timers


def run_alone(tdir, argv, out_path, src=ROOT, name="alone", runs=1):
    """The port's CLI from a copy of src's lastz_tpu_torch with nothing
    else of the repo beside it (and this tree's built libraries, so
    that an older copy with the same native sources builds none), run
    `runs` times in one process; returns its wall seconds and the last
    run's --stats timers."""
    alone = os.path.join(tdir, name)
    if not os.path.isdir(alone):
        shutil.copytree(os.path.join(src, "lastz_tpu_torch"),
                        os.path.join(alone, "lastz_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        built = os.path.join(ROOT, "lastz_tpu_torch", "build")
        if os.path.isdir(built):
            shutil.copytree(built,
                            os.path.join(alone, "lastz_tpu_torch", "build"),
                            dirs_exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("LASTZ_TPU_")}
    env["LASTZ_TORCH_DEVICE"] = "cuda"
    t0 = time.monotonic()
    with open(out_path, "w") as f:
        proc = subprocess.run([sys.executable, "-c", _ALONE, alone,
                               str(runs), *argv],
                              stdout=f, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=alone)
    if proc.returncode != 0:
        raise RuntimeError(f"the port from {src} exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    return time.monotonic() - t0, stats_timers(proc.stderr)


def run_port(argv, out_path, *contexts):
    """The port's CLI in this process, its standard output in out_path,
    with every launch counter and device_search.runs at 0 before it and
    `contexts` entered around it.  Returns (wall s, launches, the run's
    stats, device searches, what each context yielded)."""
    import torch
    import lastz_tpu_torch.stats as tstats
    from lastz_tpu_torch import cli
    from lastz_tpu_torch.search import device_hits
    os.environ["LASTZ_TORCH_DEVICE"] = "cuda"
    reset_counts()
    device_hits.device_search.runs = 0
    err = io.StringIO()
    t0 = time.monotonic()
    with open(out_path, "w") as f, contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(f))
        stack.enter_context(contextlib.redirect_stderr(err))
        got = [stack.enter_context(c) for c in contexts]
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_counts()
    if rc != 0:
        raise RuntimeError(f"port CLI {argv} exited {rc}: "
                           f"{err.getvalue()[-2000:]}")
    return (wall, launches, tstats.current, device_hits.device_search.runs,
            got)


def run_host(argv, out_path):
    """lastz_tpu's CLI, the reference, in a child process with no
    LASTZ_TPU_* switch (its host path); returns its wall seconds."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LASTZ_TPU_")}
    t0 = time.monotonic()
    with open(out_path, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "lastz_tpu.cli", *argv], stdout=f,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"lastz_tpu host run exited "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    return time.monotonic() - t0


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def require_seed_on_device(st, seed_runs, what):
    """The run's seed stage went through device_search only."""
    if seed_runs <= 0:
        raise AssertionError(f"{what}: the seed stage did not run through "
                             f"lastz_tpu_torch's device_search")
    if st.extra.get("seed host searches"):
        raise AssertionError(f"{what}: {st.extra['seed host searches']} "
                             f"seed host searches")


def csr_uploads():
    """Position tables that device.carry_state digested and uploaded."""
    from lastz_tpu_torch import device
    return sum(1 for mine in device._CACHE.values() for k in mine
               if k[0] == "csr")


def phase_main(card, pair, parent=None):
    """Returns each kernel's launch count in the port's main-path run,
    the mean device ms a launch there of its kernels, the walk's summed
    chain floor there, the arguments of its first chain-walk launch,
    the mega launches' report and lastz_tpu's LAV of the pair (its
    files' directory as TDIR).  With `parent` (a checkout of an older commit), its port
    also runs alone on the pair and its timers are printed beside
    this one's."""
    from lastz_tpu_torch import device
    with tempfile.TemporaryDirectory() as tdir:
        t0 = time.monotonic()
        tp, qp, lt, lq = write_pair(tdir, pair)
        say("main", pair_bp=[lt, lq], write_s=round(time.monotonic() - t0, 3))
        argv = [tp, qp, "--stats"]
        port_out = os.path.join(tdir, "port.lav")
        device._CACHE.clear()
        port_s, launches, st, seed_runs, (probes, built, mega_calls) = \
            run_port(argv, port_out, main_path_probes(), table_watch(),
                     mega_capture())
        say("main", run="lastz_tpu_torch.cli", wall_s=port_s,
            launches=launches, device_seed_searches=seed_runs,
            gapped_anchors=st.gapped_anchors, gapped_device=st.gapped_device,
            gapped_host=st.gapped_host, hsps=st.hsps,
            alignments=st.alignments,
            timers={k: round(v, 3) for k, v in st.timers.items()},
            extra=st.extra, card=card)
        say("main", pos_table_s=st.timers.get("pos table"),
            hitgen_setup_s=st.timers.get("hitgen setup"),
            csr_uploads=csr_uploads(), card=card,
            note="the parent's are in PERF.md section 5, or in the "
                 "parent line with --parent")
        require_in_place(built, "main path")
        if csr_uploads():
            raise AssertionError("main path: the device table was digested "
                                 "and uploaded again")
        require_launched(launches, tuple(MAIN_ENTRIES))
        main_ms, walk_floor = main_path_report(probes, launches, card)
        mega_main = check_main_mega(mega_calls, walk_floor, card)
        mega_main.update(main_path_total_ms=launch_ms(
            probes["ydrop_mega"])["total_ms"])
        del mega_calls
        if st.gapped_device <= 0:
            raise AssertionError("no anchor was extended on the device")
        require_seed_on_device(st, seed_runs, "main path")
        if launches["resolve_chains_recover"]:
            raise AssertionError("main path: a recover-mode chain walk")
        host_out = os.path.join(tdir, "host.lav")
        host_s = run_host(argv, host_out)
        a, b = read_bytes(port_out), read_bytes(host_out)
        say("main", run="lastz_tpu.cli host", wall_s=host_s,
            lav_bytes=[len(a), len(b)], lav_equal=a == b, card=card)
        if a != b:
            raise AssertionError("port LAV differs from lastz_tpu host LAV")
        # the reference LAV of the pair, its directory as TDIR (the LAV
        # names the files it read)
        host_lav = b.replace(tdir.encode(), TDIR)
        alone_out = os.path.join(tdir, "alone.lav")
        alone_s, alone_t = run_alone(tdir, argv, alone_out)
        c = read_bytes(alone_out)
        say("main", run="lastz_tpu_torch.cli alone", wall_s=alone_s,
            lav_bytes=len(c), lav_equal=a == c, timers=alone_t, card=card)
        if a != c:
            raise AssertionError("the port alone wrote other LAV")
        if parent:
            # in turns, parent, this, this, parent: each a process that
            # runs the job twice, the second run's timers kept
            for who in ("parent", "alone", "alone", "parent"):
                out = os.path.join(tdir, f"{who}.warm.lav")
                wall, timers = run_alone(
                    tdir, argv, out, src=parent if who == "parent" else ROOT,
                    name=who, runs=2)
                d = read_bytes(out)
                say("main", run=f"{who} lastz_tpu_torch.cli, second run in "
                    f"one process", src=parent if who == "parent" else ".",
                    wall_s=wall, lav_equal=a == d, timers=timers,
                    pos_table_s=timers.get("pos table"),
                    hitgen_setup_s=timers.get("hitgen setup"), card=card)
                if a != d:
                    raise AssertionError(f"{who}: the port wrote other LAV")
    chain_launch = probes["chain_launch"]
    if not chain_launch:
        raise AssertionError("main path: no chain walk was captured")
    return launches, main_ms, walk_floor, chain_launch[0], mega_main, host_lav


# the seed modes beside the main path: (name, options, chain-walk mode)
SEED_MODES = [("recover", ["--recoverseeds"], "recover"),
              ("overweight", ["--word=20"], "simple"),
              ("capsule", [], "simple")]


def phase_modes(card, pair):
    """--recoverseeds, --word=20 (an overweight seed) and a capsule
    (--writecapsule by the port, then --targetcapsule twice in this
    process) on the main path's pair, each with every counter at 0
    before it: LAV byte-equal to lastz_tpu's CLI, the seed stage on the
    device only, launches of K2 and of the chain walk in its mode; the
    capsule's second run reuses the first one's DeviceIndex.  Returns
    each phase's launches and the first recover-mode chain-walk
    launch's arguments."""
    from lastz_tpu_torch import device
    from lastz_tpu_torch.index import capsule
    out = {}
    recover_launch = None
    with tempfile.TemporaryDirectory() as tdir:
        tp, qp, _, _ = write_pair(tdir, pair)
        cap = os.path.join(tdir, "t.cap")
        t0 = time.monotonic()
        run_port([tp, f"--writecapsule={cap}"], os.path.join(tdir, "w.txt"))
        say("capsule", written_bytes=os.path.getsize(cap),
            wall_s=time.monotonic() - t0, card=card)
        for name, opts, mode in SEED_MODES:
            argv = ([f"--targetcapsule={cap}", qp] if name == "capsule"
                    else [tp, qp]) + opts
            runs = 2 if name == "capsule" else 1
            device._CACHE.clear()
            indexes = []
            see_index = observed(capsule, "open_capsule_to_device",
                                 lambda a, kw, res: indexes.append(res[2]))
            port_out = [os.path.join(tdir, f"{name}{i}.lav")
                        for i in range(runs)]
            with see_index:
                for i in range(runs):
                    port_s, launches, st, seed_runs, (chain, _) = run_port(
                        argv, port_out[i], chain_capture(), table_watch())
                    what = f"{name} run {i}"
                    require_seed_on_device(st, seed_runs, what)
                    require_launched(launches, ("xdrop_scan", "resolve_chains"))
                    want = launches["resolve_chains"] * (mode == "recover")
                    if launches["resolve_chains_recover"] != want:
                        raise AssertionError(f"{what}: chain walks in the "
                                             f"wrong mode: {launches}")
                    if mode == "recover" and recover_launch is None:
                        recover_launch = chain[0]
                    say(name, run=i, options=opts, wall_s=port_s, launches=launches,
                        device_seed_searches=seed_runs, hsps=st.hsps,
                        gapped_device=st.gapped_device,
                        timers={k: round(v, 3) for k, v in st.timers.items()},
                        csr_uploads=csr_uploads(), card=card)
            if name == "capsule":
                if len(indexes) != 2 or indexes[0] is not indexes[1]:
                    raise AssertionError("capsule: the second run did not "
                                         "reuse the memoized DeviceIndex")
                from lastz_tpu_torch.index.postable import DevicePositionTable
                if csr_uploads() or DevicePositionTable.host_fetches:
                    raise AssertionError("capsule: the device index was "
                                         "uploaded again or fetched")
            host_out = os.path.join(tdir, f"{name}.host.lav")
            host_s = run_host(argv, host_out)
            b = read_bytes(host_out)
            same_lav = [read_bytes(p) == b for p in port_out]
            say(name, run="lastz_tpu.cli host", wall_s=host_s,
                lav_bytes=len(b), lav_equal=same_lav, card=card)
            if not all(same_lav) or b"a {" not in b:
                raise AssertionError(f"{name}: port LAV differs from "
                                     f"lastz_tpu's (or holds no alignment)")
            out[name] = launches
    if recover_launch is None:
        raise AssertionError("recover: no chain walk was captured")
    return out, recover_launch


# the batched seed search's runs on the main path's target: twin seed
# hits, and a quantum query (the pair's query as quantum DNA, scored
# with QSCORES), each query cut to its *_BP so that lastz_tpu's host run
# of it takes about a minute.  The twin spans start at -19 (a span of a
# seed's length: consecutive hits on one diagonal are twins) and the
# seed queue holds every hit: with larger minima a conserved segment's
# run of consecutive hits fills a hash's 32-entry ring, and with the
# default queue an entry ages out, and either makes lastz_tpu's batched
# twin resolution (and the port's) hand the search to the scalar engine
TWINS_OPTIONS = ["--twins=-19..200", "--seedqueue=67108864"]
TWINS_BP = 2_000_000
QUANTUM_BP = 250_000
QSCORES = os.path.join(ROOT, "tests", "golden", "quantum", "qscores.txt")
# the wide path: batch_xdrop_device on an alphabet of K codes (K2's wide
# instantiation), `hits` hits of a related pair of `bp` bases
WIDE_PATH = dict(K=40, bp=1_000_000, hits=1 << 18, x_drop=400)


def write_qdna(tdir, seq):
    """seq (ACGT bytes) as a quantum DNA file, A, C, G and T as the
    bytes 1 to 4 of QSCORES' alphabet, written by the port's
    any_to_qdna in a child process; returns the query's specifier."""
    code = np.zeros(256, np.uint8)
    code[list(b"ACGT")] = [1, 2, 3, 4]
    path = os.path.join(tdir, "q.qdna")
    with open(path, "wb") as f:
        subprocess.run([sys.executable, "-m",
                        "lastz_tpu_torch.tools.any_to_qdna",
                        "--striplinebreaks"], input=code[seq].tobytes(),
                       stdout=f, check=True, cwd=ROOT)
    return f"{path}[quantum]"


@contextlib.contextmanager
def batched_calls():
    """Counts, inside the block, the calls of the batched search's
    x-drop scans (the device one and the two host ones) and the twin
    resolution's rewinds to the scalar search; yields the dict."""
    from lastz_tpu_torch.ops import xdrop_batch
    from lastz_tpu_torch.search import twins
    calls = {}
    with contextlib.ExitStack() as stack:
        for mod, name in ((xdrop_batch, "batch_xdrop_device"),
                          (xdrop_batch, "batch_xdrop_native"),
                          (xdrop_batch, "batch_xdrop_np"),
                          (twins, "restore")):
            calls[name] = 0
            stack.enter_context(observed(
                mod, name, lambda a, kw, out, name=name:
                calls.__setitem__(name, calls[name] + 1)))
        yield calls


def phase_batched(card, pair):
    """--twins and a quantum query on the main path's target, each query
    cut (TWINS_BP, QUANTUM_BP), every counter at 0 before each: LAV
    byte-equal to lastz_tpu's CLI (its host path, a child process), K2
    launched through the batched search's device branch, no host x-drop
    scan, no rewind to the scalar search; then the wide path
    (wide_path).  Returns each run's launches."""
    from lastz_tpu_torch import device
    out = {}
    with tempfile.TemporaryDirectory() as tdir:
        t, q, _ = pair
        tp = os.path.join(tdir, "t.fa")
        _write_fasta(tp, "t", t)
        qp = os.path.join(tdir, "q.fa")
        _write_fasta(qp, "q", q[:TWINS_BP])
        runs = [("twins", [tp, qp, *TWINS_OPTIONS], TWINS_BP),
                ("quantum", [tp, write_qdna(tdir, q[:QUANTUM_BP]),
                             f"Q={QSCORES}"], QUANTUM_BP)]
        for name, argv, query_bp in runs:
            device._CACHE.clear()
            port_out = os.path.join(tdir, f"{name}.lav")
            port_s, launches, st, _, (calls,) = run_port(argv, port_out,
                                                         batched_calls())
            say(name, options=argv[2:], target_bp=len(t), query_bp=query_bp,
                wall_s=port_s, launches=launches, batched_calls=calls,
                hsps=st.hsps, gapped_device=st.gapped_device,
                timers={k: round(v, 3) for k, v in st.timers.items()},
                card=card)
            if (launches["xdrop_scan"] <= 0 or calls["batch_xdrop_device"] <= 0
                    or calls["batch_xdrop_native"] or calls["batch_xdrop_np"]
                    or calls["restore"]):
                raise AssertionError(f"{name}: the batched search did not "
                                     f"run on the device only: {calls}")
            host_out = os.path.join(tdir, f"{name}.host.lav")
            host_s = run_host(argv, host_out)
            a, b = read_bytes(port_out), read_bytes(host_out)
            say(name, run="lastz_tpu.cli host", wall_s=host_s,
                lav_bytes=[len(a), len(b)], lav_equal=a == b, card=card)
            if a != b or b"a {" not in b:
                raise AssertionError(f"{name}: port LAV differs from "
                                     f"lastz_tpu's (or holds no alignment)")
            out[name] = launches
    out["wide"] = wide_path(card)
    return out


def wide_path(card):
    """The batched search's x-drop through its entry point,
    batch_xdrop_device, on an alphabet of WIDE_PATH's K codes (K2's wide
    instantiation), with every counter at 0 before it: results equal to
    the same call on CPU tensors (the plain version).  Returns its
    launches."""
    import torch
    from lastz_tpu_torch.ops.xdrop_batch import batch_xdrop_device
    K, n, H, x_drop = (WIDE_PATH[k] for k in ("K", "bp", "hits", "x_drop"))
    rng = np.random.default_rng(K)
    sym = np.arange(33, 33 + K - 1, dtype=np.uint8)  # and NUL: K codes
    s1 = sym[rng.integers(0, K - 1, n)]
    s2 = np.where(rng.random(n) < 0.15, sym[rng.integers(0, K - 1, n)], s1)
    s2 = np.where((np.arange(n) % 10_000) < 3_000, s2,
                  sym[rng.integers(0, K - 1, n)]).astype(np.uint8)
    sub = rng.integers(-60, 20, (256, 256)).astype(np.int64)
    sub[sym, sym] = rng.integers(40, 100, K - 1)
    pos1 = rng.integers(19, n, H)
    pos2 = np.where(rng.random(H) < 0.5, pos1, rng.integers(19, n, H))
    reset_counts()
    t0 = time.monotonic()
    got = batch_xdrop_device(s1, s2, sub, pos1, pos2, x_drop,
                             torch.device("cuda"))
    wall_s = time.monotonic() - t0
    launches = read_counts()
    require_launched(launches, ("xdrop_scan", "xdrop_scan_wide"))
    want = batch_xdrop_device(s1, s2, sub, pos1, pos2, x_drop,
                              torch.device("cpu"))
    equal = all(np.array_equal(got[k], want[k]) for k in want)
    say("wide", K=K, bp=n, hits=H, wall_s=wall_s, launches=launches,
        mean_right_consumed=float(got["right_consumed"].mean()),
        equal=equal, card=card)
    if not equal:
        raise AssertionError("wide: batch_xdrop_device on the card differs "
                             "from its plain version")
    return launches


# the farm phase: the pair's query cut into FARM_QUERIES queries (about
# 520 kbp each), two workers on card 0; the --twins farm on the first
# TWINS_FARM_BP of the query cut into TWINS_FARM_QUERIES queries
FARM_QUERIES = 8
FARM_SLOTS = ["cuda:0", "cuda:0"]
TWINS_FARM_BP = 1_000_000
TWINS_FARM_QUERIES = 4
FARM_THREAD = "lastz-torch-farm-"


def write_queries(path, q, n):
    """q cut into n queries of about equal length, one FASTA."""
    cut = np.linspace(0, len(q), n + 1).astype(int)
    with open(path, "w") as f:
        for i, (a, b) in enumerate(zip(cut[:-1], cut[1:])):
            f.write(f">q{i}\n")
            for j in range(a, b, 80):
                f.write(bytes(q[j:min(j + 80, b)]).decode() + "\n")


@contextlib.contextmanager
def entry_streams():
    """Every call of the kernel library's entry points inside the block
    as (calling thread's name, entry, the stream handle it was passed,
    the thread's current card); yields the list."""
    import torch
    from lastz_tpu_torch.kernels import build
    lib = build.load()
    seen = []
    owns = {entry: getattr(lib, entry) for entry in build._SIGNATURES}

    def recorder(entry, own):
        def call(*a):
            seen.append((threading.current_thread().name, entry, a[-1],
                         torch.cuda.current_device()))
            return own(*a)
        return call
    for entry, own in owns.items():
        setattr(lib, entry, recorder(entry, own))
    try:
        yield seen
    finally:
        for entry, own in owns.items():
            setattr(lib, entry, own)


@contextlib.contextmanager
def upload_watch():
    """Counts the uploads that device._cached made inside the block, by
    (device, stream, key); yields the Counter."""
    from lastz_tpu_torch import device
    made = Counter()
    own = device._cached

    def cached(dev, key, make):
        def counted():
            made[(*device.stream_key(dev), key)] += 1
            return make()
        return own(dev, key, counted)
    device._cached = cached
    try:
        yield made
    finally:
        device._cached = own


def farm_report(seen, workers, what, need=tuple(MAIN_ENTRIES)):
    """Each of the `workers` farm threads launched the kernels `need`
    (by default the main path's: K1's mega launch, K2, the walk and the
    chain walk), every launch on one non-default stream of its own, and
    no other thread launched; returns each worker's launches by
    kernel and each one's (stream, card)."""
    import torch
    default = {torch.cuda.default_stream(d).cuda_stream
               for d in range(torch.cuda.device_count())}
    by_thread = defaultdict(list)
    for name, entry, stream, dev in seen:
        by_thread[name].append((entry, stream, dev))
    names = [f"{FARM_THREAD}{k}" for k in range(workers)]
    if set(by_thread) != set(names):
        raise AssertionError(f"{what}: launches came from threads "
                             f"{sorted(by_thread)}, not the workers {names}")
    streams = {}
    per_worker = {}
    for name in names:
        calls = by_thread[name]
        own = {(stream, dev) for _, stream, dev in calls}
        if len(own) != 1 or next(iter(own))[0] in default:
            raise AssertionError(f"{what}: {name} launched on the streams "
                                 f"{own}, not on one of its own")
        streams[name] = own.pop()
        n = Counter(entry for entry, _, _ in calls)
        for k in need:
            if not n[MAIN_ENTRIES[k]]:
                raise AssertionError(f"{what}: {name} never launched {k}")
        per_worker[name] = {k: n[e] for k, e in MAIN_ENTRIES.items()}
    if len(set(streams.values())) != workers:
        raise AssertionError(f"{what}: workers shared a stream: {streams}")
    return per_worker, {k: list(v) for k, v in streams.items()}


def require_single_uploads(made, what):
    """No upload was made twice on one stream, and no position table
    was digested and uploaded (the device-built one is read in place)."""
    twice = {k: n for k, n in made.items() if n > 1}
    if twice:
        raise AssertionError(f"{what}: uploads made more than once on a "
                             f"stream: {list(twice.values())}")
    if any(k[2][0] == "csr" for k in made):
        raise AssertionError(f"{what}: the position table was uploaded")


def farm_run(argv, out, slots, *contexts, farmed=True):
    """run_port with the pipeline's FARM_SLOTS set to `slots` (None: the
    serial run); requires that run_farmed ran where slots are given and
    `farmed`, and nowhere else."""
    import lastz_tpu_torch.pipeline as tpipe
    from lastz_tpu_torch import device
    from lastz_tpu_torch.parallel import farm
    device._CACHE.clear()
    ran = []
    tpipe.FARM_SLOTS = slots
    try:
        got = run_port(argv, out, observed(
            farm, "run_farmed", lambda a, kw, res: ran.append(len(a[3]))),
            *contexts)
    finally:
        tpipe.FARM_SLOTS = None
    if bool(ran) != (slots is not None and farmed):
        raise AssertionError(f"farm over {slots}: run_farmed ran {ran}")
    return got


# one rank of a two-process gloo group on the card: the port's CLI with
# LASTZ_TORCH_DIST=1, jax and lastz_tpu blocked; rank 0 keeps its LAV
_DIST = r"""
import contextlib, io, sys
rank, world, addr, out, root = sys.argv[1:6]
sys.modules["jax"] = None
sys.modules["lastz_tpu"] = None
sys.path.insert(0, root)
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method=addr, world_size=int(world),
                        rank=int(rank))
from lastz_tpu_torch import cli
from lastz_tpu_torch.parallel import distributed
ran = []
own = distributed.run_distributed
def run_distributed(*a):
    ran.append(1)
    return own(*a)
distributed.run_distributed = run_distributed
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = cli.main(sys.argv[6:])
torch.cuda.synchronize()
assert rc == 0 and ran, (rc, ran)
if rank == "0":
    with open(out, "w") as f:
        f.write(buf.getvalue())
dist.destroy_process_group()
print("RANK_DONE", rank)
"""


def run_dist(tdir, argv, out, world=2):
    """The port's CLI in `world` processes of a gloo group over
    localhost, all on the card; returns the wall seconds."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        addr = f"tcp://127.0.0.1:{sk.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LASTZ_TPU_")}
    env.update(LASTZ_TORCH_DIST="1", LASTZ_TORCH_DEVICE="cuda")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST, str(r), str(world), addr, out, ROOT,
         *argv], env=env, cwd=tdir, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(world)]
    results = []
    try:
        for p in procs:
            results.append((*p.communicate(timeout=600), p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (so, se, rc) in enumerate(results):
        if rc != 0 or "RANK_DONE" not in so:
            raise RuntimeError(f"gloo rank {r} exited {rc}: {se[-2000:]}")
    return time.monotonic() - t0


def phase_farm(card, pair):
    """The query farm-out on the card (see the module's docstring);
    returns each worker's launches by kernel in the first farm run."""
    import torch
    from lastz_tpu_torch.index.postable import DevicePositionTable
    workers = len(FARM_SLOTS)
    with tempfile.TemporaryDirectory() as tdir:
        t, q, _ = pair
        tp = os.path.join(tdir, "t.fa")
        _write_fasta(tp, "t", t)
        qp = os.path.join(tdir, "q.fa")
        write_queries(qp, q, FARM_QUERIES)
        argv = [tp, qp]
        say("farm", queries=FARM_QUERIES, query_bp=len(q), slots=FARM_SLOTS,
            card=card)
        turns = []
        lav = {}
        per_worker = None
        for turn, who in enumerate(("serial", "farm", "farm", "serial")):
            out = os.path.join(tdir, f"{who}{turn}.lav")
            wall, launches, st, seed_runs, (_, seen, made, built) = \
                farm_run(argv, out, FARM_SLOTS if who == "farm" else None,
                         entry_streams(), upload_watch(), table_watch())
            what = f"farm phase, {who} run {turn}"
            require_in_place(built, what)
            require_single_uploads(made, what)
            require_seed_on_device(st, seed_runs, what)
            require_launched(launches, tuple(MAIN_ENTRIES))
            lav[turn] = read_bytes(out)
            turns.append(dict(run=who, wall_s=wall))
            # a farm run's timers are its workers' summed
            say("farm", run=who, turn=turn, wall_s=wall, launches=launches,
                gapped_device=st.gapped_device, alignments=st.alignments,
                timers={k: round(v, 3) for k, v in st.timers.items()},
                uploads=sum(made.values()),
                host_fetches=DevicePositionTable.host_fetches, card=card)
            if who == "farm":
                got, streams = farm_report(seen, workers, what)
                say("farm", turn=turn, launches_per_worker=got,
                    worker_streams=streams, card=card)
                per_worker = per_worker or got
        if len(set(lav.values())) != 1 or b"a {" not in lav[0]:
            raise AssertionError("farm: the farm's LAV differs from the "
                                 "serial run's (or holds no alignment)")
        host_out = os.path.join(tdir, "host.lav")
        host_s = run_host(argv, host_out)
        same = read_bytes(host_out) == lav[0]
        say("farm", run="lastz_tpu.cli host", wall_s=host_s,
            lav_bytes=len(lav[0]), lav_equal=same, card=card)
        if not same:
            raise AssertionError("farm: the serial LAV differs from "
                                 "lastz_tpu's host LAV")
        say("farm", walls_in_turns=turns, card=card)
        cards = torch.cuda.device_count()
        if cards > 1:
            slots = [f"cuda:{d}" for d in range(cards)]
            out = os.path.join(tdir, "cards.lav")
            wall, _, _, _, (_, seen, made) = farm_run(
                argv, out, slots, entry_streams(), upload_watch())
            got, streams = farm_report(seen, cards, "farm over every card")
            require_single_uploads(made, "farm over every card")
            say("farm", slots=slots, wall_s=wall, launches_per_worker=got,
                worker_streams=streams, lav_equal=read_bytes(out) == lav[0],
                card=card)
            if read_bytes(out) != lav[0]:
                raise AssertionError("farm over every card: other LAV")
            # a job the farm declines (--census) runs serially, its
            # queries pinned to the cards in turn
            census = []
            for who, slots_ in (("serial", None), ("pinned", slots)):
                out = os.path.join(tdir, f"census.{who}.lav")
                wall, _, _, _, (_, seen) = farm_run(
                    argv + ["--census"], out, slots_, entry_streams(),
                    farmed=False)
                census.append(read_bytes(out))
                on = sorted({d for _, _, _, d in seen})
                say("farm", run=f"--census {who}", wall_s=wall,
                    cards_launched_on=on, card=card)
            if census[0] != census[1] or on != list(range(cards)):
                raise AssertionError("--census pinned over every card: "
                                     "other LAV, or not on every card")
        dist_out = os.path.join(tdir, "dist.lav")
        dist_s = run_dist(tdir, argv, dist_out)
        same = read_bytes(dist_out) == lav[0]
        say("farm", run="two gloo processes on the card", wall_s=dist_s,
            lav_equal=same, card=card)
        if not same:
            raise AssertionError("farm: rank 0's LAV differs from the "
                                 "serial run's")
        farm_twins(card, tdir, tp, q)
    return per_worker


def farm_twins(card, tdir, tp, q):
    """--twins over two workers on TWINS_FARM_BP of the query cut into
    TWINS_FARM_QUERIES queries: the serial run's LAV, and K2 launched
    through the batched search's device branch on both workers' own
    streams, no host x-drop scan."""
    qp = os.path.join(tdir, "twins.fa")
    write_queries(qp, q[:TWINS_FARM_BP], TWINS_FARM_QUERIES)
    argv = [tp, qp, *TWINS_OPTIONS]
    lav = []
    for who, slots in (("serial", None), ("farm", FARM_SLOTS)):
        out = os.path.join(tdir, f"twins.{who}.lav")
        wall, launches, st, _, (_, calls, seen) = farm_run(
            argv, out, slots, batched_calls(), entry_streams())
        lav.append(read_bytes(out))
        say("farm", run=f"twins {who}", options=TWINS_OPTIONS,
            queries=TWINS_FARM_QUERIES, query_bp=TWINS_FARM_BP, wall_s=wall,
            launches=launches, batched_calls=calls, card=card)
        if (calls["batch_xdrop_device"] <= 0 or calls["batch_xdrop_native"]
                or calls["batch_xdrop_np"] or calls["restore"]):
            raise AssertionError(f"twins {who}: the batched search did not "
                                 f"run on the device only: {calls}")
        if slots is not None:
            got, streams = farm_report(seen, len(slots), "twins farm",
                                       need=("xdrop_scan",))
            say("farm", run="twins farm", launches_per_worker=got,
                worker_streams=streams, card=card)
    if lav[0] != lav[1] or b"a {" not in lav[0]:
        raise AssertionError("twins farm: LAV differs from the serial run")


def phase_index(card, pair):
    """The device build of the position table against the host build,
    on the main path's target and on an INDEX_BP target with lowercase
    and N runs, default 12of19 seed: equal csr_start, csr_pos[:n] and
    n_entries; both times and the device memory peak."""
    import torch
    from lastz_tpu_torch.core.encoding import UPPER_NUC_TO_BITS
    from lastz_tpu_torch.core.seeds import SEED_12OF19, parse_seed
    from lastz_tpu_torch.index.postable import (
        build_seed_position_table, build_seed_position_table_device)
    dev = torch.device("cuda")
    seed = parse_seed(SEED_12OF19, with_trans=1)
    t0 = time.monotonic()
    big = make_index_target()
    say("index", made_bp=len(big), make_s=time.monotonic() - t0)
    # warm-up: the sort and scan kernels' first launches
    build_seed_position_table_device(big[:100_000], 0, 0, UPPER_NUC_TO_BITS,
                                     seed, device=dev)
    for name, t in (("pair target", pair[0]), ("index target", big)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        got = build_seed_position_table_device(t, 0, 0, UPPER_NUC_TO_BITS,
                                               seed, device=dev)
        torch.cuda.synchronize()
        dev_s = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - before
        t0 = time.monotonic()
        host = build_seed_position_table(t, 0, 0, UPPER_NUC_TO_BITS, seed)
        host_s = time.monotonic() - t0
        n = got.n_entries
        equal = (n == len(host.csr_pos)
                 and np.array_equal(got.dev_csr_start.cpu().numpy(),
                                    host.csr_start)
                 and np.array_equal(got.dev_csr_pos[:n].cpu().numpy(),
                                    host.csr_pos.astype(np.int64)))
        say("index", target=name, bp=len(t), entries=n,
            words=got.num_words, device_build_s=dev_s, host_build_s=host_s,
            device_peak_bytes=peak,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            equal=equal, card=card)
        if not equal:
            raise AssertionError(f"index {name}: device build differs from "
                                 f"the host build")
        del got, host
    return big


def make_index_target():
    """INDEX_BP of random ACGT with lowercase runs (soft-masked repeats)
    over about a third of it and N runs (gaps), from its own seed."""
    rng = np.random.default_rng(64)
    n = INDEX_BP
    t = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for a, m in zip(rng.integers(0, n - 10_000, 6000),
                    rng.integers(100, 7000, 6000)):
        t[a: a + m] |= 0x20
    for a, m in zip(rng.integers(0, n - 60_000, 300),
                    rng.integers(10, 50_000, 300)):
        t[a: a + m] = ord("N")
    return t


def phase_extend(card, pair, refs):
    """ops/ydrop_pallas.py's path through its entry points, both
    orientations; returns each kernel's launch count in it."""
    import torch
    from lastz_tpu_torch.ops import ydrop_pallas as tp
    geo = dict(band=K3_SHAPE["band"], max_rows=K3_SHAPE["max_rows"])
    reset_counts()
    t0 = time.monotonic()
    batches = anchor_batches(pair)
    outs = {}
    for rev, batch in batches.items():
        args = [torch.from_numpy(a).cuda() for a in batch]
        outs[rev] = (tp.ydrop_extend_batch(*args, **geo),
                     tp.ydrop_band_batch(*args, **geo))
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = read_counts()
    require_launched(launches, ("ydrop_wavefront", "ydrop_band"))
    for rev, (k3, k3b) in outs.items():
        for name, got in (("ydrop_wavefront", k3), ("ydrop_band", k3b)):
            if max_abs_diff(got, refs[name][rev]):
                raise AssertionError(f"{name} reversed={rev}: the path's "
                                     f"result differs from the plain one")
            ends = got[:, 1:3]
            if bool((ends < 0).any()) or int(got[:, 1].max()) >= geo[
                    "max_rows"] or int(got[:, 2].max()) > geo["band"]:
                raise AssertionError(f"{name}: end cell off the grid")
            if float((got[:, 0] > 0).float().mean()) < 0.9:
                raise AssertionError(f"{name}: most anchors score 0")
    say("extend", anchors=K3_SHAPE["anchors"], orientations=2,
        wall_s=wall_s, launches=launches,
        best_mean={name: float(torch.cat([o[i][:, 0] for o in outs.values()])
                               .float().mean())
                   for i, name in enumerate(("ydrop_wavefront",
                                             "ydrop_band"))},
        card=card)
    return launches


# ---------------------------------------------------------------------------
# the shard phase
# ---------------------------------------------------------------------------

# the target-sharded tier: 4 shards, on one card each where there are
# four, else all on card 0; (b)'s query cut from the INDEX_BP target,
# a base in SHARD_QUERY_INDEL deleted and one inserted, and
# SHARD_QUERY_MUT of them substituted, searched with 12of19 and no
# transition (one probe a position, so the host's replay of every
# candidate stays within the phase's time); (d)'s mesh step on the
# pair's target with MESH_SHAPE's query blocks and anchors
SHARDS = 4
# the directory of the pair's files in a reference LAV
TDIR = b"<tdir>"
SHARD_QUERY_BP = 2_000_000
SHARD_QUERY_MUT = 0.15
SHARD_QUERY_INDEL = 0.01
MESH_SHAPE = dict(q_per_shard=16, qlen=4096, anchors_per_shard=64)


def shard_slots(n=SHARDS):
    """One card a shard where there are n, else all on card 0."""
    import torch
    if torch.cuda.device_count() >= n:
        return [f"cuda:{d}" for d in range(n)]
    return ["cuda:0"] * n


@contextlib.contextmanager
def k2_by_shard():
    """Every K2 call of the sharded search's per-shard program inside
    the block, by the (device, codes pointer) it read; yields the
    Counter."""
    from lastz_tpu_torch.search import sharded_mesh as tsm
    seen = Counter()
    own = tsm.xdrop_scan

    def call(seq1p, *a, **kw):
        seen[(str(seq1p.device), seq1p.data_ptr())] += 1
        return own(seq1p, *a, **kw)
    tsm.xdrop_scan = call
    try:
        yield seen
    finally:
        tsm.xdrop_scan = own


def shard_launches(index, seen, what):
    """K2's calls by shard of `index` (k2_by_shard's Counter); every
    shard must have launched."""
    got = [seen[(str(c.device), c.data_ptr())] for c in index.codes_d]
    if min(got) <= 0 or sum(got) != sum(seen.values()):
        raise AssertionError(f"{what}: K2 did not run on every shard: "
                             f"{got} of {sum(seen.values())}")
    return got


@contextlib.contextmanager
def ydrop_args():
    """The arguments of every whole-target DeviceYDrop made inside the
    block (yielded list)."""
    from lastz_tpu_torch.align import ydrop_device
    got = []
    own = ydrop_device.DeviceYDrop.__init__

    def init(self, *a, **kw):
        if type(self) is ydrop_device.DeviceYDrop:
            got.append(a)
        own(self, *a, **kw)
    ydrop_device.DeviceYDrop.__init__ = init
    try:
        yield got
    finally:
        ydrop_device.DeviceYDrop.__init__ = own


def index_bytes(index):
    """Target-derived bytes each shard's slot holds (its codes and
    CSR)."""
    return [int(index.codes_d[d].nbytes + index.csr_pos_d[d].nbytes
                + index.csr_start_d[d].nbytes)
            for d in range(index.n_shards)]


def whole_target_bytes(index):
    """The same bytes for the whole target on one device: its codes,
    every indexed position (the shards' together) and the word
    starts."""
    entries = sum(int(c[-1]) for c in index.csr_start_d)
    return int(index.n + 4 * entries + index.csr_start_d[0].nbytes)


def shard_cli(card, pair, host_lav):
    """(a): the pair through the port's CLI with LASTZ_TORCH_SHARDS and
    SHARD_SLOTS, unsharded and sharded in turns, each LAV host_lav's
    (its files' directory TDIR); returns the launch counts of the first
    sharded run, the DeviceYDrop arguments of its gapped stage and its
    index."""
    import torch
    from lastz_tpu_torch.search import sharded_mesh as tsm
    slots = shard_slots()
    with tempfile.TemporaryDirectory() as tdir:
        host_lav = host_lav.replace(TDIR, tdir.encode())
        tp, qp, _, _ = write_pair(tdir, pair)
        argv = [tp, qp, "--stats"]
        first = None
        for turn, who in enumerate(("unsharded", "sharded", "unsharded")):
            path = os.path.join(tdir, f"{who}{turn}.lav")
            tsm._INDEX_CACHE.clear()
            if who == "sharded":
                os.environ["LASTZ_TORCH_SHARDS"] = str(SHARDS)
                tsm.SHARD_SLOTS = slots
            try:
                wall, launches, st, seed_runs, (events, seen, yd) = \
                    run_port(argv, path, timed_launches("xdrop_scan_launch"),
                             k2_by_shard(), ydrop_args())
            finally:
                os.environ.pop("LASTZ_TORCH_SHARDS", None)
                tsm.SHARD_SLOTS = None
            lav = read_bytes(path)
            timers = {k: round(v, 3) for k, v in st.timers.items()}
            say("shard", run=f"cli {who}", turn=turn, shards=SHARDS,
                slots=slots, wall_s=wall, launches=launches,
                lav_equal=lav == host_lav, timers=timers, extra=st.extra,
                card=card)
            if lav != host_lav:
                raise AssertionError(f"shard cli {who}: LAV differs from "
                                     f"lastz_tpu's host LAV")
            if st.extra.get("seed host searches"):
                raise AssertionError(f"shard cli {who}: seed host searches")
            if who == "unsharded":
                continue
            index = next(iter(tsm._INDEX_CACHE.values()))
            by_shard = shard_launches(index, seen, "shard cli")
            if seed_runs or "shard search" not in st.timers:
                raise AssertionError("shard cli: the seed stage did not go "
                                     "through the sharded search only")
            require_launched(launches, tuple(MAIN_ENTRIES)[:3])
            k2 = launch_ms(events)
            say("shard", run="cli sharded K2", launches_by_shard=by_shard,
                k2_ms_per_launch=k2["mean_ms"], k2_median_ms=k2["median_ms"],
                k2_total_ms=k2["total_ms"], shard_search_s=timers.get(
                    "shard search"),
                shard_index_build_s=timers.get("shard index build"),
                card=card)
            if first is None:
                first = (launches, yd[0], index)
            if len(set(slots)) == SHARDS:
                # (e): one shard a card, none holding the whole target
                mine = index_bytes(index)
                whole = whole_target_bytes(index)
                say("shard", run="one shard a card", index_bytes=mine,
                    whole_target_bytes=whole, memory_allocated=[
                        torch.cuda.memory_allocated(d)
                        for d in range(SHARDS)], card=card)
                if max(mine) >= whole:
                    raise AssertionError("shard cli: a card holds as much "
                                         "as the whole target")
    return first


def shard_index_target(card, big, query_bp=SHARD_QUERY_BP):
    """(b): the INDEX_BP target in SHARDS shards against a mutated
    SHARD_QUERY_BP query cut from it: the sharded search's hits against
    the port's unsharded device search on the whole target; returns the
    sharded search's launches and K2's calls by shard."""
    import torch
    from lastz_tpu_torch.config import GFEX_XDROP, ScoreThreshold
    from lastz_tpu_torch.core.encoding import UPPER_NUC_TO_BITS
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    from lastz_tpu_torch.core.seeds import SEED_12OF19, parse_seed
    from lastz_tpu_torch.index import sharded as tsharded
    from lastz_tpu_torch.index.postable import (
        build_seed_position_table_device)
    from lastz_tpu_torch.search import device_hits
    from lastz_tpu_torch.search import sharded_mesh as tsm
    from lastz_tpu_torch.search.engine import (HitProcessorParams,
                                               SeedSearchEngine)
    import lastz_tpu_torch.stats as tstats
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    at = int(rng.integers(0, len(big) - query_bp))
    q = big[at: at + query_bp][rng.random(query_bp) >= SHARD_QUERY_INDEL]
    mut = rng.random(len(q)) < SHARD_QUERY_MUT
    q[mut] = alpha[rng.integers(0, 4, mut.sum())]
    ins = np.nonzero(rng.random(len(q)) < SHARD_QUERY_INDEL)[0]
    q = np.insert(q, ins, alpha[rng.integers(0, 4, len(ins))])
    seed = parse_seed(SEED_12OF19, with_trans=0)
    sc = new_dna_score_set()
    hp = HitProcessorParams(gf_extend=GFEX_XDROP, scoring=sc, x_drop=910,
                            hsp_threshold=ScoreThreshold("S", 3000))

    def engine(pt, hits, device=None):
        return SeedSearchEngine(
            big, pt, q, seed, UPPER_NUC_TO_BITS, hp,
            lambda p1, p2, ln, s: hits.append((p1, p2, ln, s)) or ln,
            device=device)

    pt = build_seed_position_table_device(big, 0, 0, UPPER_NUC_TO_BITS,
                                          seed, device=dev)
    torch.cuda.synchronize()
    whole = []
    tstats.reset()
    device_hits.device_search.runs = 0
    t0 = time.monotonic()
    engine(pt, whole, dev).search(0, len(q))
    torch.cuda.synchronize()
    whole_s = time.monotonic() - t0
    if not device_hits.device_search.runs or \
            tstats.current.extra.get("seed host searches"):
        raise AssertionError("shard index target: the unsharded search did "
                             "not run on the device")
    builds = []
    own = tsharded.build_seed_position_table

    def timed_build(*a, **kw):
        t = time.monotonic()
        got = own(*a, **kw)
        builds.append(time.monotonic() - t)
        return got
    tsharded.build_seed_position_table = timed_build
    try:
        t0 = time.monotonic()
        index = tsm.MeshShardedIndex(big, UPPER_NUC_TO_BITS, seed, 1, SHARDS,
                                     sc.sub, slots=shard_slots())
        torch.cuda.synchronize()
        index_s = time.monotonic() - t0
    finally:
        tsharded.build_seed_position_table = own
    sharded = []
    reset_counts()
    tstats.reset()
    with k2_by_shard() as seen, \
            timed_launches("xdrop_scan_launch") as events:
        t0 = time.monotonic()
        got = tsm.sharded_mesh_search(engine(pt, sharded), index)
        torch.cuda.synchronize()
        sharded_s = time.monotonic() - t0
    launches = read_counts()
    by_shard = shard_launches(index, seen, "shard index target")
    k2 = launch_ms(events)
    mine = index_bytes(index)
    whole_b = whole_target_bytes(index)
    say("shard", run="index target", target_bp=len(big), query_bp=len(q),
        seed="12of19, no transition", hits=[len(whole), len(sharded)],
        hits_equal=sharded == whole, unsharded_search_s=whole_s,
        sharded_search_s=sharded_s, index_build_s=index_s,
        index_build_s_by_shard=builds, shard_search_s=tstats.current.timers
        .get("shard search"), raw_seed_hits=tstats.current.raw_seed_hits,
        launches=launches, launches_by_shard=by_shard,
        k2_ms_per_launch=k2["mean_ms"], k2_total_ms=k2["total_ms"],
        per_shard_bytes=mine,
        per_device_target_bytes=index.per_device_target_bytes,
        whole_target_bytes=whole_b, card=card)
    if got is None or sharded != whole or len(whole) == 0:
        raise AssertionError("shard index target: the sharded hits differ "
                             "from the unsharded device search's")
    if max(mine) >= whole_b:
        raise AssertionError("shard index target: a slot holds as much as "
                             "the whole target")
    require_launched(launches, ("xdrop_scan",))
    return launches


def shard_gapped(card, args, index):
    """(c): ShardedTargetYDrop on the first mega batch of the CLI's
    gapped stage (the DeviceYDrop arguments `args`), lane for lane
    against DeviceYDrop on the whole target; returns its launches."""
    import torch
    from lastz_tpu_torch.align.ydrop_device import DeviceYDrop
    from lastz_tpu_torch.align.ydrop_sharded import ShardedTargetYDrop
    whole = DeviceYDrop(*args)
    shard = ShardedTargetYDrop(index, *args)
    if not (whole.ok and shard.ok):
        raise AssertionError("shard gapped: a y-drop was refused")
    n = min(whole.batch, len(args[6]))
    t0 = time.monotonic()
    whole.result_for(0)
    torch.cuda.synchronize()
    whole_s = time.monotonic() - t0
    reset_counts()
    t0 = time.monotonic()
    shard.result_for(0)
    torch.cuda.synchronize()
    shard_s = time.monotonic() - t0
    launches = read_counts()
    differ = [k for k in range(n)
              for side in ("fwd", "rev")
              for key in whole.result_for(k)[side]
              if whole.result_for(k)[side][key]
              != shard.result_for(k)[side][key]]
    differ += [k for k in range(n) if whole._ops[k] != shard._ops[k]]
    rows = [int(whole.result_for(k)[s]["rows_used"]) for k in range(n)
            for s in ("fwd", "rev")]
    say("shard", run="gapped", anchors=n, lanes=2 * n, launches=launches,
        max_rows=max(rows), whole_s=whole_s, sharded_s=shard_s,
        lanes_equal=not differ, card=card)
    if differ:
        raise AssertionError(f"shard gapped: anchors {sorted(set(differ))} "
                             f"differ from the whole-target DeviceYDrop")
    require_launched(launches, ("ydrop_mega", "ydrop_traceback"))
    return launches


def shard_mesh_step(card, pair, shape=MESH_SHAPE):
    """(d): parallel/mesh.py's step on SHARDS slots, on one slot and on
    CPU tensors, every output equal; returns the SHARDS-slot run's
    launches."""
    import torch
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    from lastz_tpu_torch.core.seeds import SEED_12OF19, parse_seed
    from lastz_tpu_torch.parallel import mesh as tmesh
    t, q, _ = pair
    nq = SHARDS * shape["q_per_shard"]
    queries = [q[i * shape["qlen"]: (i + 1) * shape["qlen"]]
               for i in range(nq)]
    seed = parse_seed(SEED_12OF19, with_trans=0)
    t0 = time.monotonic()
    inp = tmesh.build_mesh_inputs(t, queries, seed, new_dna_score_set(),
                                  SHARDS, **shape)
    build_s = time.monotonic() - t0
    args = (inp["q_codes"], inp["t_codes"], inp["csr_start"], inp["sub4"],
            inp["subsmall"], inp["anchors12"], inp["state"], inp["a_small"],
            inp["b_small"])
    outs = {}
    walls = {}
    launches = None
    for who, slots in (("cuda x4", shard_slots()), ("cuda x1", ["cuda:0"]),
                       ("cpu", ["cpu"])):
        step = tmesh.make_sharded_pipeline(slots, seed, gap_e=inp["gap_e"],
                                           gap_oe=inp["gap_oe"])
        reset_counts()
        t0 = time.monotonic()
        got = step(*args)
        torch.cuda.synchronize()
        walls[who] = time.monotonic() - t0
        if launches is None:
            launches = read_counts()
        outs[who] = [o.cpu() for o in got]
    names = ["counts", "hsp_score", "ydrop_score", "end1", "end2", "census",
             "total_hits"]
    differ = [n for i, n in enumerate(names)
              if not (torch.equal(outs["cuda x4"][i], outs["cpu"][i])
                      and torch.equal(outs["cuda x1"][i], outs["cpu"][i]))]
    say("shard", run="mesh step", slots=shard_slots(), anchors=int(
        inp["anchors12"].shape[0]), lanes=256, rows=128, build_s=build_s,
        walls=walls, launches=launches, total_hits=int(outs["cpu"][6]),
        scored=int((outs["cpu"][2] > 0).sum()), equal=not differ, card=card)
    if differ:
        raise AssertionError(f"shard mesh step: {differ} differ between "
                             f"slot counts or from the CPU")
    if int(outs["cpu"][6]) <= 0 or not bool((outs["cpu"][2] > 0).any()):
        raise AssertionError("shard mesh step: no hit or no y-drop score")
    require_launched(launches, ("ydrop_chunk", "xdrop_scan"))
    return launches


def phase_shard(card, pair, host_lav, big):
    """The target-sharded tier (see the module's docstring); returns the
    launches of each of its paths, by path."""
    t0 = time.monotonic()
    cli_launches, args, index = shard_cli(card, pair, host_lav)
    got = dict(cli=cli_launches)
    got["index_target"] = shard_index_target(card, big)
    got["gapped"] = shard_gapped(card, args, index)
    got["mesh_step"] = shard_mesh_step(card, pair)
    say("shard", wall_s=time.monotonic() - t0, card=card)
    return got


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an older commit: its "
                    "port also runs the main path, alone, beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_toolchain()
    t0 = time.monotonic()
    pair = make_pair()
    say("pair", bp=[len(pair[0]), len(pair[1])], segments=len(pair[2]),
        make_s=round(time.monotonic() - t0, 3))
    rows, refs, chain_err = phase_kernels(card, pair)
    big = phase_index(card, pair)
    launches, main_ms, walk_floor, main_chain, mega_main, host_lav = \
        phase_main(card, pair, args.parent)
    mode_launches, recover_chain = phase_modes(card, pair)
    batched_launches = phase_batched(card, pair)
    farm_launches = phase_farm(card, pair)
    shard_paths = phase_shard(card, pair, host_lav, big)
    del big
    rows.append(chain_row(card, chain_err, main_chain, recover_chain))
    launches.update({k: v for k, v in phase_extend(card, pair, refs).items()
                     if k in ("ydrop_wavefront", "ydrop_band")})
    # main_path_ms: the mean device ms of a launch on the main path (K1,
    # K2, the walk, the chain walk); the walk's chain floors are at the
    # table's shape and summed over its main-path launches
    # K1 runs on the main path as its mega launch: its row's launches are
    # those, and its main_path_ms the mega launches' device ms over the
    # chunks they ran; the chunk entry's own launches stand beside them.
    # K2's wide instantiation counts its launches on the wide path.
    for r in rows:
        name = r["name"]
        r["launches"] = launches[name]
        if name == "ydrop_chunk":
            r["launches"] = launches["ydrop_mega"]
            r["chunk_entry_launches"] = launches["ydrop_chunk"]
        if name == "xdrop_scan_wide":
            r["launches"] = batched_launches["wide"]["xdrop_scan_wide"]
        if name in main_ms:
            r["main_path_ms"] = main_ms[name]
        if name == "ydrop_traceback":
            r["main_path_chain_floor_ms"] = walk_floor
        if name == "ydrop_mega":
            r.update(mega_main)
            r["max_abs_err"] = max(r["max_abs_err"],
                                   mega_main["main_path_max_abs_err"])
        if name in ("xdrop_scan", "resolve_chains"):
            r["launches_by_seed_mode"] = {
                k: v[name] for k, v in mode_launches.items()}
        if name in MAIN_ENTRIES:
            r["farm_launches_per_worker"] = {
                k: v[name] for k, v in farm_launches.items()}
        if name == "xdrop_scan":
            r["launches_by_batched_mode"] = {
                k: v["xdrop_scan"] for k, v in batched_launches.items()}
        # the shard phase's paths: the CLI under LASTZ_TORCH_SHARDS, the
        # INDEX_BP target's sharded search, ShardedTargetYDrop and the
        # mesh step (the chunk entry's launches in ydrop_chunk's row)
        r["launches_by_shard_path"] = {k: v[name]
                                       for k, v in shard_paths.items()}
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
