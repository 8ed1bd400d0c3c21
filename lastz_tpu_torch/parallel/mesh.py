"""Multi-device scaling: query-data-parallel sharding over device slots
(port of lastz_tpu/parallel/mesh.py, whose shard_map over a "dp" mesh
axis becomes a loop over a list of slots).

The reference's distribution story is "run N processes over query
shards, sharing the target index via a mmapped capsule"
(capsule.c:6-15 + README farm-out recipe).  Here:

  * the target's seed index (CSR arrays), its codes and the score
    tables are REPLICATED, one copy a slot device;
  * query blocks (fixed-size padded code arrays) are SHARDED along the
    slots, as are the anchor batches derived from them;
  * each slot runs the production kernels on its shard: spaced-seed
    word packing (core/seeds.py bit maps), CSR hit counts, the
    gap-free x-drop along each anchor's diagonal (K2,
    ops/xdrop_cuda.xdrop_scan, one chunk of `xchunk` cells) and one
    exact y-drop chunk (K1's chunk entry, ops/ydrop_cuda.ydrop_chunk);
  * the per-target-base census (dynamic masking state, the only
    cross-query coupling in the reference, masking.c:6-25) and the
    hit total are summed over the slots onto slot 0's device.

Every slot is launched before any result is gathered.  The step
returns what lastz_tpu's does; K2's kbest, which differs from
xdrop_scan_jnp's argmax where best <= 0, is not among it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import SEQ_PAD, resolve_device
from ..ops.xdrop_cuda import xdrop_scan
from ..ops.ydrop_cuda import ydrop_chunk
from ..ops.ydrop_exact import STATE_KEYS
from ..search.sharded_mesh import slot_context

_I32 = torch.int32
_I64 = torch.int64
_U32 = 0xFFFFFFFF
# the x-drop scans' score of a cell with an invalid code
_INVALID = -(1 << 20)


def pack_words(query_codes, seed):
    """Spaced-seed word packing of a (Q, L) block of 2-bit codes (-1
    invalid): the window/bit-map construction of
    index/postable._window_words + Seed.pack (reference apply_seed,
    seeds.c), with lastz_tpu's uint32 arithmetic (pack_words_jnp :42):
    bits shifted past 32 are lost.  Returns (packed int32 (Q, num),
    valid bool)."""
    Q, L = query_codes.shape
    length = seed.length
    bits_per = seed.bits_per_base
    num = L - length + 1
    c = query_codes.to(_I64)
    w = torch.zeros((Q, num), dtype=_I64, device=c.device)
    valid = torch.ones((Q, num), dtype=torch.bool, device=c.device)
    for i in range(length):
        seg = c[:, i: i + num]
        valid &= seg >= 0
        code = torch.clamp(seg, min=0)
        if bits_per == 2:
            w = ((w << 2) | code) & _U32
        else:
            w = ((w << 1) | (code & 1)) & _U32
    packed = torch.zeros_like(w)
    for src, dst in seed.bit_map:  # a seed's weight is below 32 bits
        packed |= ((w >> src) & 1) << dst
    return packed.to(_I32), valid


def _take(csr_start, ix):
    """csr_start[ix], 0 where ix is out of range (jnp.take's fill)."""
    n = csr_start.shape[0]
    ok = (ix >= 0) & (ix < n)
    return torch.where(ok, csr_start[torch.clamp(ix, 0, n - 1)].to(_I64), 0)


def _k2_inputs(target_codes, qflat, sub4):
    """K2's operands for 2-bit codes: codes + 1 (0 for an invalid code)
    as int8 padded by SEQ_PAD, and the 5 x 5 table whose row and column
    0 score _INVALID."""
    def padded(codes):
        out = torch.zeros(codes.shape[0] + 2 * SEQ_PAD, dtype=torch.int8,
                          device=codes.device)
        out[SEQ_PAD: SEQ_PAD + codes.shape[0]] = torch.where(
            codes >= 0, codes + 1, 0).to(torch.int8)
        return out
    sub = torch.full((5, 5), _INVALID, dtype=_I32, device=sub4.device)
    sub[1:, 1:] = sub4.to(_I32)
    return padded(target_codes), padded(qflat), sub.reshape(-1)


def _slot_step(d, query_codes, target_codes, csr_start, sub4, subsmall,
               anchors12, state, a_small, b_small, *, seed, lanes, rows,
               xchunk, gap_e, gap_oe, y_drop, x_drop):
    """lastz_tpu's per-shard step body (:117-176) on one slot's
    tensors; d is the slot's index (its query block's offset)."""
    dev = query_codes.device
    # 1. seed stage: word packing + CSR hit counts
    words, valid = pack_words(query_codes, seed)
    counts = _take(csr_start, words.to(_I64) + 1) \
        - _take(csr_start, words.to(_I64))
    counts = torch.where(valid, counts, 0).to(_I32)

    # 2. gap-free x-drop along each anchor's diagonal: anchor query
    # coordinates are GLOBAL flat positions, localized to this slot's
    # block, every scan bounded by its own query (so results do not
    # depend on the slot count); K2 over one chunk of xchunk cells
    qflat = query_codes.reshape(-1)
    L = query_codes.shape[1]
    T = target_codes.shape[0]
    p1 = anchors12[:, 0].to(_I64)
    p2 = anchors12[:, 1].to(_I64) - d * qflat.shape[0]
    q_ix = torch.div(p2, L, rounding_mode="floor")
    blk_lo = q_ix * L
    blk_hi = blk_lo + L
    n_r = torch.minimum(T - p1, blk_hi - p2)
    n_l = torch.minimum(p1, p2 - blk_lo)
    s1p, s2p, sub5 = _k2_inputs(target_codes, qflat, sub4)
    (_, l_best, _), (_, r_best, _) = xdrop_scan(
        s1p, s2p, sub5, 5, p1, p2, torch.clamp(n_l, 0, xchunk),
        torch.clamp(n_r, 0, xchunk), x_drop)
    hsp_score = r_best + l_best

    # 3. one exact y-drop chunk over this slot's anchors (K1's chunk
    # entry; lastz_tpu runs ydrop_exact._chunk_one here)
    A = anchors12.shape[0]
    zero = torch.zeros(A, dtype=_I32, device=dev)
    M = torch.clamp(n_r, max=rows)
    N = torch.clamp(n_r, max=lanes - 2)
    out_state, _ = ydrop_chunk(
        a_small, b_small, zero, zero, M, N, state, subsmall, gap_e=gap_e,
        gap_oe=gap_oe, y_drop=y_drop, lanes=lanes, rows=rows,
        alpha=subsmall.shape[0], trim_to_peak=True, tb_cap=80 << 20,
        want_tb=False)

    # 4. this slot's census of target coverage
    lens = out_state["rows_used"].to(_I64)
    r_iota = torch.arange(rows, dtype=_I64, device=dev)
    pos = (p1[:, None] + r_iota[None, :]).reshape(-1)
    cover = (r_iota[None, :] < lens[:, None]).reshape(-1)
    inside = (pos >= 0) & (pos < T)
    census = torch.zeros(T, dtype=_I32, device=dev)
    census.index_add_(0, torch.where(inside, pos, 0),
                      (cover & inside).to(_I32))
    yscore = torch.where(out_state["bflag"], out_state["bscore"],
                         out_state["best"])
    return (counts, hsp_score, yscore.to(_I32), out_state["end1"].to(_I32),
            out_state["end2"].to(_I32), census, counts.to(_I64).sum())


def make_sharded_pipeline(slots, seed, lanes=256, rows=128, xchunk=128,
                          gap_e=30, gap_oe=430, y_drop=3000, x_drop=910):
    """The multi-device step over the production kernels, on `slots` (a
    list of devices, "cpu" or "cuda:i", where lastz_tpu takes a Mesh).

    Inputs (to the returned function; numpy arrays or tensors):
      query_codes: (n_slots*Qb, L) int32 2-bit codes, split on slots
      target_codes: (T,) int32 2-bit target codes, replicated
      csr_start: (4^w + 1,) int32 CSR offsets, replicated
      sub4: (4, 4) int32 substitution scores (2-bit alphabet)
      subsmall: (16, 16) int32 compact-alphabet scores, replicated
      anchors12: (n_slots*A, 2) int32 (target, query-flat) anchor
                 points, split on slots
      state: the y-drop chunk's fresh state (dict of (n_slots*A, ...)),
             split on slots
      a_small, b_small: (n_slots*A, rows) and (n_slots*A, lanes) codes,
             split on slots

    Returns, on slot 0's device: (counts, hsp_score, yscore, end1, end2,
    census, total_hits), as lastz_tpu's step.
    """
    slots = [resolve_device(s) for s in slots]
    kw = dict(seed=seed, lanes=lanes, rows=rows, xchunk=xchunk, gap_e=gap_e,
              gap_oe=gap_oe, y_drop=y_drop, x_drop=x_drop)

    def tensor(a, dev):
        if torch.is_tensor(a):
            return a.to(dev)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def step(query_codes, target_codes, csr_start, sub4, subsmall,
             anchors12, state, a_small, b_small):
        S = len(slots)
        if query_codes.shape[0] % S or anchors12.shape[0] % S:
            raise ValueError("queries and anchors must split evenly over "
                             "the slots")
        qb = query_codes.shape[0] // S
        ab = anchors12.shape[0] // S
        replicated = {}
        outs = []
        for d, dev in enumerate(slots):
            if str(dev) not in replicated:
                replicated[str(dev)] = [tensor(a, dev) for a in (
                    target_codes, csr_start, sub4, subsmall)]
            tc, cs, s4, ss = replicated[str(dev)]
            q = slice(d * qb, (d + 1) * qb)
            a = slice(d * ab, (d + 1) * ab)
            with slot_context(dev):
                outs.append(_slot_step(
                    d, tensor(query_codes[q], dev), tc, cs, s4, ss,
                    tensor(anchors12[a], dev),
                    {k: tensor(state[k][a], dev) for k in STATE_KEYS},
                    tensor(a_small[a], dev), tensor(b_small[a], dev), **kw))
        home = slots[0]
        cat = [torch.cat([o[i].to(home) for o in outs]) for i in range(5)]
        census = outs[0][5].to(home)
        total = outs[0][6].to(home)
        for o in outs[1:]:
            census = census + o[5].to(home)
            total = total + o[6].to(home)
        return (*cat, census, total)

    return step


def build_mesh_inputs(target_v, queries_v, seed, scoring, n_shards,
                      q_per_shard, qlen, anchors_per_shard,
                      lanes=256, rows=128, y_drop=3000, rng_seed=0):
    """Host-side preparation of the sharded step's inputs from REAL
    sequences: builds the production position table over the target,
    packs query blocks, derives anchor points from actual seed-word
    matches, and builds the y-drop chunk's fresh state + windows."""
    from ..core.encoding import UPPER_NUC_TO_BITS
    from ..index.postable import build_seed_position_table
    from ..ops.ydrop_exact import fresh_state_np, make_compact_alphabet

    pt = build_seed_position_table(
        target_v, 0, 0, UPPER_NUC_TO_BITS, seed, 1)
    t_codes = UPPER_NUC_TO_BITS[target_v].astype(np.int32)

    nq = n_shards * q_per_shard
    q_codes = np.full((nq, qlen), -1, np.int32)
    for i in range(min(nq, len(queries_v))):
        src = UPPER_NUC_TO_BITS[queries_v[i][:qlen]].astype(np.int32)
        q_codes[i, :len(src)] = src

    # anchors: real seed-word matches (first CSR entry per probe),
    # generated per shard from the shard's OWN query block so that a
    # sharded anchor row always references local queries
    rng = np.random.default_rng(rng_seed)
    A = n_shards * anchors_per_shard
    qflat = q_codes.reshape(-1)
    anchors = []
    for s in range(n_shards):
        blk_lo = s * q_per_shard * qlen
        blk_hi = (s + 1) * q_per_shard * qlen
        got = 0
        tries = 0
        while got < anchors_per_shard and tries < 500 * anchors_per_shard:
            tries += 1
            qpos = int(rng.integers(blk_lo + seed.length,
                                    blk_hi - lanes))
            window = qflat[qpos - seed.length: qpos]
            if (window < 0).any():
                continue
            w = 0
            for c in window:
                w = (w << 2) | int(c)
            packed = int(seed.pack(np.array([w], np.uint64))[0])
            lo = int(pt.csr_start[packed])
            hi = int(pt.csr_start[packed + 1])
            if hi <= lo:
                continue
            pos1 = int(pt.adj_start + pt.step * pt.csr_pos[lo])
            if pos1 + rows + 2 >= len(target_v) or pos1 < 2:
                continue
            anchors.append((pos1, qpos))
            got += 1
        while got < anchors_per_shard:
            anchors.append((2, blk_lo + seed.length))
            got += 1
    anchors12 = np.array(anchors[:A], np.int32)

    code_map, subsmall = make_compact_alphabet(
        [target_v, np.concatenate([q[:qlen] for q in queries_v])
         if len(queries_v) else np.zeros(1, np.uint8)],
        scoring.sub, max_k=16)

    N = np.minimum(len(target_v) - anchors12[:, 0], lanes - 2)
    gap_e = int(scoring.gap_extend)
    gap_oe = int(scoring.gap_open + scoring.gap_extend)
    state, _ = fresh_state_np(N.astype(np.int64), gap_e, gap_oe,
                              y_drop, lanes, A)

    # per-anchor kernel windows from the raw characters
    a_small = np.zeros((A, rows), np.int32)
    b_small = np.zeros((A, lanes), np.int32)
    qraw = np.zeros(nq * qlen, np.uint8)
    for i in range(min(nq, len(queries_v))):
        src = queries_v[i][:qlen]
        qraw[i * qlen: i * qlen + len(src)] = src
    for j, (a1, a2) in enumerate(anchors12):
        src = target_v[a1 + 1: a1 + 1 + rows]
        a_small[j, :len(src)] = code_map[src]
        src = qraw[a2: a2 + lanes]
        b_small[j, :len(src)] = code_map[src]

    csr32 = pt.csr_start.astype(np.int32)
    sub4 = scoring.dna4.astype(np.int32)
    return dict(q_codes=q_codes, t_codes=t_codes, csr_start=csr32,
                sub4=sub4, subsmall=subsmall, anchors12=anchors12,
                state=state, a_small=a_small, b_small=b_small,
                gap_e=gap_e, gap_oe=gap_oe)
