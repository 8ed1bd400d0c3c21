"""The port's K3 and K3b (lastz_tpu_torch/ops/ydrop_pallas.py) against
lastz_tpu/ops/ydrop_pallas.py on the CPU: the plain K3 equals the
Pallas wavefront kernel run by ydrop_extend_batch(interpret=True), the
plain K3b equals _ydrop_band_kernel in an interpret-mode pallas_call
built here with ydrop_extend_batch's grid spec, the plain row sweep
equals ydrop_extend_batch_xla, and prepare_anchor_batch equals JAX's.
Inputs come from numpy seeds 0, 1 and 2; integers, tolerance 0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lastz_tpu.core.scoring import new_dna_score_set
from lastz_tpu.ops import ydrop_pallas as jp
from lastz_tpu_torch.ops import ydrop_pallas as tp

BAND, ROWS, B = 128, 128, 40  # B is not a multiple of SUBBATCH (32)
GAP_E, GAP_OE = 30, 430
EMPTY = 5  # the anchor whose cells all stay below 0


def _batch(seed, y_drop):
    """Related code pairs with ragged ends, divergent stretches that
    make a y-drop of a few hundred prune, and one anchor (EMPTY) that
    scores below 0 everywhere."""
    rng = np.random.default_rng(seed)
    sub4 = new_dna_score_set().dna4.astype(np.int32)
    base = rng.integers(0, 4, (B, max(ROWS, BAND))).astype(np.int32)
    C1 = base[:, :ROWS].copy()
    C2 = base[:, :BAND].copy()
    mut = rng.random(C2.shape) < 0.1
    C2[mut] = (C2[mut] + 1) % 4
    for i in range(B):
        lo = int(rng.integers(10, BAND))
        C2[i, lo: lo + int(rng.integers(0, 40))] = rng.integers(0, 4)
        C1[i, int(rng.integers(ROWS // 2, ROWS + 1)):] = -1
        C2[i, int(rng.integers(BAND // 2, BAND)):] = -1
    C2[:, BAND - 1] = -1
    C1[EMPTY] = np.where(C1[EMPTY] >= 0, 0, -1)  # A against T only
    C2[EMPTY] = np.where(C2[EMPTY] >= 0, 3, -1)
    P = np.tile(np.array([GAP_E, GAP_OE, y_drop, BAND - 1], np.int32),
                (B, 1))
    return C1, C2, sub4, P


def _jax_band(C1, C2, sub4, P):
    """_ydrop_band_kernel through pallas_call in interpret mode, with
    the scalars and grid spec of ydrop_extend_batch."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    S = jp.SUBBATCH
    pad = -len(C1) % S
    C1 = np.concatenate([C1, np.full((pad, ROWS), -1, np.int32)])
    C2 = np.concatenate([C2, np.full((pad, BAND), -1, np.int32)])
    scalars = jnp.asarray(np.concatenate(
        [P[0, :3], [0], sub4.reshape(16)]).astype(np.int32))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(len(C1) // S,),
        in_specs=[
            pl.BlockSpec((S, ROWS), lambda b, *_: (b, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((S, BAND), lambda b, *_: (b, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((S, 128), lambda b, *_: (b, 0),
                               memory_space=pltpu.VMEM),
    )
    out = pl.pallas_call(
        functools.partial(jp._ydrop_band_kernel, band=BAND, max_rows=ROWS),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((len(C1), 128), jnp.int32),
        interpret=True,
    )(scalars, jnp.asarray(C1), jnp.asarray(C2))
    return np.asarray(out)[: len(P)]


def _port(fn, C1, C2, sub4, P):
    return fn(*map(torch.from_numpy, (C1, C2, sub4, P)), band=BAND,
              max_rows=ROWS).numpy()


YDROPS = {"inactive": 10 ** 7, "pruning": 300}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ydrop", list(YDROPS))
def test_wavefront_matches_pallas_interpret(seed, ydrop):
    C1, C2, sub4, P = _batch(seed, YDROPS[ydrop])
    ref = np.asarray(jp.ydrop_extend_batch(
        *map(jnp.asarray, (C1, C2, sub4, P)), band=BAND, max_rows=ROWS,
        interpret=True))
    got = _port(tp.ydrop_extend_batch, C1, C2, sub4, P)
    assert got.shape == (B, 128)
    assert np.array_equal(got, ref)
    assert tuple(got[EMPTY, :3]) == (0, 0, 1)  # no cell reaches 0
    if ydrop == "pruning":  # the y-drop bites on some anchors
        free = _port(tp.ydrop_extend_batch, C1, C2, sub4,
                     _batch(seed, YDROPS["inactive"])[3])
        assert (free[:, :3] != got[:, :3]).any(axis=1).sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ydrop", list(YDROPS))
def test_band_matches_pallas_interpret(seed, ydrop):
    C1, C2, sub4, P = _batch(seed, YDROPS[ydrop])
    got = _port(tp.ydrop_band_batch, C1, C2, sub4, P)
    assert np.array_equal(got, _jax_band(C1, C2, sub4, P))
    assert tuple(got[EMPTY, :3]) == (0, 0, BAND - 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ydrop", list(YDROPS))
def test_row_sweep_matches_xla(seed, ydrop):
    C1, C2, sub4, P = _batch(seed, YDROPS[ydrop])
    P[::3, 2] += 100  # per-anchor y-drop: this version reads every row
    ref = np.asarray(jp.ydrop_extend_batch_xla(
        *map(jnp.asarray, (C1, C2, sub4, P)), band=BAND, max_rows=ROWS))
    got = _port(tp.ydrop_extend_batch_xla, C1, C2, sub4, P)
    assert np.array_equal(got, ref)
    assert tuple(got[EMPTY, :3]) == (0, 0, 0)


@pytest.mark.parametrize("ydrop", list(YDROPS))
@pytest.mark.parametrize("plain", [tp.ydrop_wavefront_plain,
                                   tp.ydrop_band_plain])
def test_live_span_counts_the_cells_the_y_drop_keeps(plain, ydrop):
    """The cells the bound counts: the whole on-grid rectangle while the
    y-drop never bites, fewer once it prunes; the result is the same
    with or without the count."""
    C1, C2, sub4, P = _batch(0, YDROPS[ydrop])
    args = [torch.from_numpy(a) for a in (C1, C2, sub4, P)]
    out, span = plain(*args, band=BAND, max_rows=ROWS, live_span=True)
    assert torch.equal(out, plain(*args, band=BAND, max_rows=ROWS))
    grid = (C1 >= 0).sum(1) * (C2 >= 0).sum(1)
    if ydrop == "inactive":
        assert np.array_equal(span.numpy(), grid)
    else:
        assert (span.numpy() <= grid).all()
        assert 0 < span.sum() < grid.sum() // 2


@pytest.mark.parametrize("reversed_", [False, True])
def test_prepare_anchor_batch_matches_jax(reversed_):
    rng = np.random.default_rng(4)
    v1 = rng.integers(-1, 4, 3000).astype(np.int8)
    v2 = rng.integers(-1, 4, 2500).astype(np.int8)
    anchors = [(int(a), int(b)) for a, b in
               zip(rng.integers(0, 3000, 50), rng.integers(0, 2500, 50))]
    anchors += [(0, 0), (2999, 2499), (5, 2490), (2990, 3)]
    args = (v1, v2, anchors, GAP_E, GAP_OE, 9400)
    kw = dict(band=BAND, max_rows=ROWS, reversed_=reversed_)
    for a, b in zip(jp.prepare_anchor_batch(*args, **kw),
                    tp.prepare_anchor_batch(*args, **kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_wrappers_refuse_other_devices():
    C1, C2, sub4, P = (torch.from_numpy(a) for a in _batch(0, 300))
    meta = torch.device("meta")
    for fn in (tp.ydrop_extend_batch, tp.ydrop_band_batch):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(C1.to(meta), C2.to(meta), sub4, P, band=BAND, max_rows=ROWS)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ydrop", list(YDROPS))
def test_wavefront_early_stop_changes_nothing(seed, ydrop):
    """The invariant K3's early stop relies on: past the rows that
    ydrop_wavefront_rows says a sweep needs, codes1 may hold anything
    (here -1) and the result stays the same, for the plain K3 and for
    the Pallas wavefront kernel in interpret mode.  Some anchors hold
    -1 codes inside codes1 (off-grid rows, where D stays alive)."""
    C1, C2, sub4, P = _batch(seed, YDROPS[ydrop])
    C1[7, 20:26] = -1
    C1[8, 3:40:3] = -1
    args = [torch.from_numpy(a) for a in (C1, C2, sub4, P)]
    rows = tp.ydrop_wavefront_rows(*args, band=BAND, max_rows=ROWS).numpy()
    last = np.where(C1 >= 0, np.arange(ROWS), -1).max(1) + 1
    assert (rows <= last).all()
    if ydrop == "pruning":
        assert (rows < last).sum() > B // 4  # the stop saves rows
    else:
        assert np.array_equal(rows, last)
    cut = np.where(np.arange(ROWS)[None, :] < rows[:, None], C1, -1)
    ref = _port(tp.ydrop_extend_batch, C1, C2, sub4, P)
    assert np.array_equal(_port(tp.ydrop_extend_batch, cut, C2, sub4, P),
                          ref)
    got_j = [np.asarray(jp.ydrop_extend_batch(
        *map(jnp.asarray, (c, C2, sub4, P)), band=BAND, max_rows=ROWS,
        interpret=True)) for c in (C1, cut)]
    assert np.array_equal(got_j[0], got_j[1])
    assert np.array_equal(got_j[0], ref)


# K3b's early stop: YDROPS at the default gaps, a column-0 boundary that
# stays alive through every row (D at column 0 falls by 1 a row, and
# column 1, which it reaches, never scores above 91, so -40 - r stays
# above its prune threshold), and a y-drop too large for the wrap guard,
# which then refuses the stop
BAND_STOP_CASES = {"inactive": (GAP_E, GAP_OE, YDROPS["inactive"]),
                   "pruning": (GAP_E, GAP_OE, YDROPS["pruning"]),
                   "live_boundary": (1, 20, 1000),
                   "no_guard": (GAP_E, GAP_OE, 1 << 28)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(BAND_STOP_CASES))
def test_band_early_stop_changes_nothing(seed, case):
    """The invariant K3b's early stop relies on: past the rows that
    ydrop_band_rows says the kernel sweeps, codes1 may hold anything
    (here -1) and the result stays the same, for the plain K3b and for
    _ydrop_band_kernel in an interpret-mode pallas_call.  Some anchors
    hold -1 codes inside codes1 (off-grid rows, where D stays alive); a
    stop is only ever tested on every 32nd row."""
    C1, C2, sub4, P = _batch(seed, 0)
    P[:, :3] = BAND_STOP_CASES[case]
    C1[7, 20:26] = -1
    C1[8, 3:40:3] = -1
    args = [torch.from_numpy(a) for a in (C1, C2, sub4, P)]
    rows = tp.ydrop_band_rows(*args, band=BAND, max_rows=ROWS).numpy()
    assert (rows <= ROWS).all()
    assert ((rows % tp.STOP_EVERY == 0) | (rows == ROWS)).all()
    if case == "pruning":
        assert (rows < ROWS).sum() > B // 4  # the stop saves rows
    else:  # nothing is pruned, column 1 lives, or the guard refuses
        assert (rows == ROWS).all()
    cut = np.where(np.arange(ROWS)[None, :] < rows[:, None], C1, -1)
    ref = _port(tp.ydrop_band_plain, C1, C2, sub4, P)
    assert np.array_equal(_port(tp.ydrop_band_plain, cut, C2, sub4, P), ref)
    got_j = [_jax_band(c, C2, sub4, P) for c in (C1, cut)]
    assert np.array_equal(got_j[0], got_j[1])
    assert np.array_equal(got_j[0], ref)


@pytest.mark.parametrize("gaps", [(0, 0), (GAP_E, GAP_OE)])
def test_band_rows_past_the_grid_are_swept(gaps):
    """Why K3b, unlike K3, does not end at the last on-grid row: its
    rows past codes1's end still carry gaps.  At zero gap costs those
    rows keep every cell of an anchor alive and move its end row, so
    the sweep cut at the last on-grid row differs and ydrop_band_rows
    keeps every row; at the default gaps the same anchors stop."""
    C1, C2, sub4, P = _batch(0, YDROPS["pruning"])
    P[:, :2] = gaps
    args = [torch.from_numpy(a) for a in (C1, C2, sub4, P)]
    ref = _port(tp.ydrop_band_plain, C1, C2, sub4, P)
    last = np.where(C1 >= 0, np.arange(ROWS), -1).max(1) + 1
    assert np.array_equal(_jax_band(C1, C2, sub4, P), ref)
    rows = tp.ydrop_band_rows(*args, band=BAND, max_rows=ROWS).numpy()
    moved = 0
    for b in np.flatnonzero(last < ROWS):
        short = tp.ydrop_band_plain(
            args[0][b: b + 1, : last[b]].contiguous(), args[1][b: b + 1],
            args[2], args[3][b: b + 1], band=BAND, max_rows=int(last[b]))
        moved += not torch.equal(short, torch.from_numpy(ref[b: b + 1]))
    if gaps == (0, 0):
        assert moved > B // 2 and (rows == ROWS).all()
    else:
        assert moved == 0 and (rows < ROWS).sum() > B // 4
