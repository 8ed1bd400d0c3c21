"""Device-resident seed search: drives ops/hitgen.py so that the raw
candidate hit list never crosses to the host (reference
seed_hit_search, seed_search.c:322-980 + the simple and recoverable
processors :1056-1420 + xdrop_extend_seed_hit :2528).

Port of lastz_tpu/search/device_hits.py (supported :49, device_search
:193-513).  The position-table CSR and both sequences' padded codes
come from device.carry_state (a table built on the device is used in
place; host arrays are uploaded once, cached by content); the 64K
diagonal-extent state (and recover mode's diagActual) stays on the
device for the whole search.

Stats: "hitgen setup" holds "hitgen setup target" (the target's codes
and table, device.carry_state) and "hitgen setup query" (the query's
codes, packed words and padding); "hitgen wait" is every blocking fetch
of the stage (here and in ops/hitgen.hit_launch).

Launch plan: query windows go in fixed-size chunks; each chunk's
candidate total is counted on the device (one scalar fetched) and cut
into fixed HIT_BUDGET launches whose only outputs are the compacted
threshold survivors.  A launch with more survivors than OUT_CAP, or a
hash chain longer than the resolver's cap, leaves the diagonal state
untouched and is re-run as two half ranges.  Each launch's survivors
become HSPs on the host through search/replay.py ("hitgen report").
"""

from __future__ import annotations

import numpy as np
import torch

from .. import stats as _stats
from ..config import GFEX_NO_EXTEND, GFEX_XDROP
from ..device import carry_state, stream_key
from ..kernels import build
from ..ops.hitgen import (HIT_BUDGET, OUT_CAP, expand_chunk, hit_launch,
                          pack_query_words, pair_counts)
from .batched import _probe_budgets, _probe_xors
from .batched import supported as _batched_supported
from .replay import Replay

_DEF_PCHUNK = 1 << 20


def supported(engine) -> bool:
    """The configurations the device runs (lastz_tpu/search/
    device_hits.py:49-82): simple and recover hit modes, plain and
    overweight (R) seeds, x-drop or no extension, int32-safe scores and
    lengths.  Twins and reverse-complement seeds go to the host engines
    (search/engine.py), like everything the batched gate declines."""
    if not _batched_supported(engine):
        return False
    if engine.hit_mode not in ("simple", "recover"):
        # twins need the 256K seed-hit queue with global aging
        # (search/twins.py)
        return False
    if engine.hit_mode == "recover" and engine.hp.gf_extend != GFEX_XDROP:
        # as the batched gate: without an extension the scalar
        # processor's diagEnd/diagActual updates differ
        return False
    if engine.seed.rev_comp:
        return False
    if engine.seed.type == "R" and getattr(
            engine.pt, "csr_resolve", None) is None:
        # overweight seeds need the index's packed resolving words
        return False
    hp = engine.hp
    sub = engine._sub
    if hp.gf_extend == GFEX_XDROP:
        if sub is None or sub.dtype != np.int64:
            return False
        if np.abs(sub).max() >= (1 << 31):
            return False
        if hp.x_drop >= (1 << 30):
            return False
    if max(len(engine.seq1), len(engine.seq2)) >= (1 << 31):
        return False
    t = engine.hp.hsp_threshold
    if t.t == "S" and abs(t.s) >= (1 << 30):
        return False
    return True


def _csr_resolve_on(pt, device):
    """The table's per-entry resolving words on `device` as int32 (their
    bits read unsigned), uploaded once per table and stream (the farm's
    workers each read their own, device.stream_key): the cache entry
    holds the host array itself, so a rebuilt array is never served the
    old upload (lastz_tpu/search/device_hits.py:259-268)."""
    per_stream = pt.__dict__.setdefault("_hitgen_res_dev", {})
    sk = stream_key(device)
    cached = per_stream.get(sk)
    if cached is None or cached[0] is not pt.csr_resolve:
        words = np.ascontiguousarray(pt.csr_resolve).astype(np.uint32)
        cached = per_stream[sk] = (
            pt.csr_resolve, torch.from_numpy(words.view(np.int32)).to(device))
    return cached[1]


def device_search(engine, device, start: int = 0, end: int = 0):
    """SeedSearchEngine.search on the device; returns bases_hit, or
    None when the configuration is not supported or the alphabet is
    wider than 16 codes."""
    if not supported(engine):
        return None
    if end == 0:
        end = len(engine.seq2)
    seed = engine.seed
    L = seed.length
    if end - start < L:
        return 0
    hp = engine.hp
    no_extend = hp.gf_extend == GFEX_NO_EXTEND
    st = _stats.current

    with st.time("hitgen setup"):
        # no scoring without an extension: any alphabet will do
        sub = (engine._sub if not no_extend
               else np.zeros((256, 256), np.int64))
        state = carry_state(engine.seq1, engine.seq2, sub, device,
                            pt=engine.pt, target=engine.target_state)
        if state is None:
            return None
        build.count(device_search, "runs")
        K = state["subsmall"].shape[0]
        subflat_d = state["subsmall_t"].reshape(-1)
        xors_d = torch.from_numpy(_probe_xors(seed)).to(device)
        nprobe = xors_d.shape[0]
        # overweight seeds: the demoted (resolving) bits of each query
        # window, the index's per-entry resolving words and the
        # per-probe transition budgets (seeds.c:8-127)
        has_resolve = seed.type == "R"
        qres = csr_resolve_d = budgets_d = None
        if has_resolve:
            with st.time("hitgen setup target"):
                csr_resolve_d = _csr_resolve_on(engine.pt, device)
            budgets_d = torch.from_numpy(_probe_budgets(seed)).to(device)
        with st.time("hitgen setup query"):
            q_codes = engine.char_to_bits[
                engine.seq2[start:end]].astype(np.int8)
            qdev = torch.from_numpy(q_codes).to(device)
            packed, valid = pack_query_words(qdev, seed.bit_map, L,
                                             seed.bits_per_base)
            if has_resolve:
                resolve_map = tuple(
                    (int(src), i) for i, src in enumerate(seed.resolve_bits))
                qres, _ = pack_query_words(qdev, resolve_map, L,
                                           seed.bits_per_base)
            num_w = end - start - L + 1
            PCHUNK = min(_DEF_PCHUNK, max(1 << 14, (1 << 24) // nprobe),
                         1 << max(8, (num_w - 1).bit_length()))
            n_chunks = (num_w + PCHUNK - 1) // PCHUNK
            pad = n_chunks * PCHUNK - num_w
            if pad:
                packed = torch.cat([packed, packed.new_zeros(pad)])
                valid = torch.cat([valid, valid.new_zeros(pad)])
                if has_resolve:
                    qres = torch.cat([qres, qres.new_zeros(pad)])
            with st.time("hitgen wait"):
                st.words_in_queries += int(valid.sum())

    csr_start = state["csr_start"]

    def chunk(c):
        sl = slice(c * PCHUNK, (c + 1) * PCHUNK)
        return pair_counts(packed[sl], valid[sl], xors_d, csr_start)

    # phase 1: per-chunk candidate totals (one small fetch)
    with st.time("hitgen counts"):
        totals = torch.stack([chunk(c)[2] for c in range(n_chunks)])
        with st.time("hitgen wait"):
            totals = totals.tolist()

    de = torch.full((65536,), -1, dtype=torch.int32, device=device)
    da = torch.zeros(65536, dtype=torch.int32, device=device)
    recover = engine.hit_mode == "recover"

    # launch budgets: modest sizes for small runs
    H = HIT_BUDGET
    total_all = sum(totals)
    while H > (1 << 15) and total_all <= H // 4:
        H //= 2
    out_cap = min(OUT_CAP, max(1 << 12, H // 8))

    thresh_is_score = hp.hsp_threshold.t == "S"
    thresh = int(hp.hsp_threshold.s) if thresh_is_score else 0
    use_thresh = thresh_is_score and thresh > 0
    band = engine.band_width if (engine.same_strand
                                 and engine.band_width > 0) else (1 << 30)
    alive_t = state["alive"]
    kw = dict(
        no_extend=no_extend, self_compare=bool(engine.self_compare),
        same_strand=bool(engine.same_strand), use_thresh=use_thresh,
        has_alive=alive_t is not None, K=K, nprobe=nprobe,
        x_drop=int(hp.x_drop) if not no_extend else 0, H=H,
        out_cap=out_cap, recover=recover, has_resolve=has_resolve)
    common = (state["seq1p"], state["seq2p"], subflat_d,
              state["csr_pos"], alive_t)

    seq1 = engine.seq1
    seq2 = engine.seq2
    rp = Replay(engine)

    for c in range(n_chunks):
        total = totals[c]
        if total == 0:
            continue
        chunk_lo = start + c * PCHUNK
        with st.time("hitgen expand"):
            cum, ends, _ = chunk(c)
            # one extra H of padding so an overflow-split launch at an
            # unaligned offset can still slice a full window
            n_launches = (total + H - 1) // H
            karr = expand_chunk(cum, (n_launches + 1) * H)
        ranges = [(b, min(b + H, total)) for b in range(0, total, H)]
        while ranges:
            lo, hi = ranges.pop(0)
            with st.time("hitgen device"):
                de2, da2, out, scalars = hit_launch(
                    *common, cum, ends, karr[lo: lo + H], de, da, lo, hi,
                    chunk_lo, int(state["adj_start"]),
                    int(state["step"]), L, thresh, band, len(seq1),
                    len(seq2), csr_resolve_d,
                    qres[c * PCHUNK: (c + 1) * PCHUNK]
                    if has_resolve else None, budgets_d, **kw)
                n_keep = int(scalars[0])
                converged = bool(scalars[4])
                with st.time("hitgen wait"):
                    out_np = out[:, :min(n_keep, out_cap)].cpu().numpy()
            if not converged or n_keep > out_cap:
                # output overflow, or a hash chain longer than the
                # resolver's cap: discard and re-run as two half ranges
                mid = (lo + hi) // 2
                if mid == lo:
                    raise RuntimeError(
                        "device_search: one hit cannot be resolved")
                ranges[:0] = [(lo, mid), (mid, hi)]
                continue
            de, da = de2, da2
            st.raw_seed_hits += int(scalars[1])
            st.hash_dropped_hits += int(scalars[2])
            st.ungapped_extensions += int(scalars[3])
            if n_keep:
                with st.time("hitgen report"):
                    r = out_np.astype(np.int64)
                    if not rp.rows(*r[:8], r[8] != 0):
                        return rp.bases_hit
        if rp.stop(c < n_chunks - 1):
            return rp.bases_hit
    rp.stop()
    return rp.bases_hit


device_search.runs = 0
