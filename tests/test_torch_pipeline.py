"""The port's whole default path (python -m lastz_tpu_torch.cli) on the
CPU against lastz_tpu: byte-equal output to lastz_tpu's host path and
to its device path (LASTZ_TPU_DEVICE=1) on the synthetic pairs of
tests/test_device_path.py, with a nonzero device gapped share; the
package imports and runs with JAX blocked; and asking for a card
where there is none raises."""

import io
import os
import subprocess
import sys

import pytest
import torch

import lastz_tpu.align.ydrop_device as jydd
import lastz_tpu.stats as lstats
import lastz_tpu_torch.align.ydrop_device as tydd
from lastz_tpu.cli import parse_options
from lastz_tpu.pipeline import Pipeline as HostPipeline
from lastz_tpu_torch import cli
from lastz_tpu_torch.device import carry_state, get_device
from lastz_tpu_torch.search import device_hits

from test_device_path import _make_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("fmt", ["lav", "maf"])
def test_cli_matches_lastz_tpu_host_and_device(tmp_path, monkeypatch,
                                               capsys, fmt):
    t, q = _make_pair(tmp_path)
    args = [t, q, f"--format={fmt}", "--ydrop=3000"]
    monkeypatch.delenv("LASTZ_TPU_DEVICE", raising=False)
    host_out = _host(args)

    monkeypatch.setenv("LASTZ_TORCH_DEVICE", "cpu")
    _small_geometry(monkeypatch, tydd)
    runs = device_hits.device_search.runs
    capsys.readouterr()
    assert cli.main(args) == 0
    port_out = capsys.readouterr().out
    st = lstats.current
    assert device_hits.device_search.runs == runs + 2  # both strands
    assert st.gapped_device > 0, \
        f"no anchor ran on the device (host={st.gapped_host})"

    monkeypatch.setenv("LASTZ_TPU_DEVICE", "1")
    _small_geometry(monkeypatch, jydd)
    jax_dev_out = _host(args)

    assert port_out == host_out
    assert port_out == jax_dev_out


_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.path.insert(0, sys.argv[1])
import lastz_tpu_torch
for m in pkgutil.walk_packages(lastz_tpu_torch.__path__, "lastz_tpu_torch."):
    importlib.import_module(m.name)
from lastz_tpu_torch import cli
from lastz_tpu_torch.align import ydrop_device
ydrop_device.DEFAULT_WIDTH = 128
ydrop_device.DEFAULT_ROWS = 256
ydrop_device.DEFAULT_BATCH = 4
rc = cli.main(sys.argv[2:])
assert "jax.numpy" not in sys.modules
sys.exit(rc)
"""


def test_runs_with_jax_blocked(tmp_path):
    t, q = _make_pair(tmp_path, n=1500, seed=5)
    env = dict(os.environ, LASTZ_TORCH_DEVICE="cpu")
    env.pop("LASTZ_TPU_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, ROOT, t, q, "--ydrop=3000"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == _host([t, q, "--ydrop=3000"])
    assert proc.stdout.startswith("#:lav")


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
    from lastz_tpu.core.scoring import new_dna_score_set
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
