"""The port's whole default path (python -m lastz_tpu_torch.cli) on the
CPU against lastz_tpu: byte-equal output to lastz_tpu's host path and
to its device path (LASTZ_TPU_DEVICE=1) on the synthetic pairs of
tests/test_device_path.py, with a nonzero device gapped share; the
package imports and runs with JAX and lastz_tpu blocked; and asking
for a card where there is none raises."""

import io

import pytest
import torch

import lastz_tpu.align.ydrop_device as jydd
import lastz_tpu_torch.align.ydrop_device as tydd
import lastz_tpu_torch.stats as tstats
from lastz_tpu.cli import parse_options
from lastz_tpu.pipeline import Pipeline as HostPipeline
from lastz_tpu_torch import cli
from lastz_tpu_torch.device import carry_state, get_device
from lastz_tpu_torch.search import device_hits

from test_device_path import _make_pair
from test_torch_isolation import run_blocked


def _host(args):
    buf = io.StringIO()
    HostPipeline(parse_options(args), buf).run()
    return buf.getvalue()


def _small_geometry(monkeypatch, mod):
    # a 512-column window and 256-row chunks: 8 retained blocks hold
    # every extension of a 4 kbp pair, at a CPU-sized cost
    monkeypatch.setattr(mod, "DEFAULT_WIDTH", 256)
    monkeypatch.setattr(mod, "DEFAULT_ROWS", 256)
    monkeypatch.setattr(mod, "DEFAULT_BATCH", 8)


@pytest.mark.parametrize("fmt", ["lav", "maf", "recoverseeds"])
def test_cli_matches_lastz_tpu_host_and_device(tmp_path, monkeypatch,
                                               capsys, fmt):
    t, q = _make_pair(tmp_path)
    args = [t, q, "--ydrop=3000"] + (
        ["--recoverseeds"] if fmt == "recoverseeds" else [f"--format={fmt}"])
    monkeypatch.delenv("LASTZ_TPU_DEVICE", raising=False)
    host_out = _host(args)

    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    _small_geometry(monkeypatch, tydd)
    runs = device_hits.device_search.runs
    capsys.readouterr()
    assert cli.main(args) == 0
    port_out = capsys.readouterr().out
    st = tstats.current
    assert device_hits.device_search.runs == runs + 2  # both strands
    assert st.gapped_device > 0, \
        f"no anchor ran on the device (host={st.gapped_host})"

    monkeypatch.setenv("LASTZ_TPU_DEVICE", "1")
    _small_geometry(monkeypatch, jydd)
    jax_dev_out = _host(args)

    assert port_out == host_out
    assert port_out == jax_dev_out


def test_runs_with_jax_blocked(tmp_path):
    """The default LAV run with `jax` and `lastz_tpu` both blocked; the
    other option sets are in test_torch_isolation.py."""
    t, q = _make_pair(tmp_path, n=1500, seed=5)
    out = run_blocked([t, q, "--ydrop=3000"])
    assert out == _host([t, q, "--ydrop=3000"])
    assert out.startswith("#:lav")


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device()
    t, q = _make_pair(tmp_path, n=500)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([t, q])
    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "tpu")
    with pytest.raises(ValueError):
        get_device()


def test_carried_state_is_keyed_on_content():
    """An upload cache keyed on id() or data_ptr() can hand one strand
    the other's codes; the port keys on content, so an array changed in
    place is uploaded again."""
    import numpy as np
    from lastz_tpu_torch.core.scoring import new_dna_score_set
    sub = new_dna_score_set().sub
    rng = np.random.default_rng(0)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)].copy()
    first = carry_state(seq, seq, sub, torch.device("cpu"))["seq1p"]
    first = first.clone()
    seq[100:200] = ord("A")
    second = carry_state(seq, seq, sub, torch.device("cpu"))["seq1p"]
    assert not torch.equal(first, second)
    assert torch.equal(second[20608:20608 + 3000].to(torch.int64),
                       torch.from_numpy(
                           carry_state(seq, seq, sub, torch.device("cpu"))
                           ["code_map"][seq].astype(np.int64)))
