"""Wrapper of the seed stage's chain-walk kernel.

  resolve_chains   csrc/resolve_chains.cu; replaces the device
                   while_loops lastz_tpu/ops/hitgen.py::_resolve_chains_dev
                   (:345, simple hit mode) and
                   _resolve_chains_recover_dev (:408, recover mode)

For CUDA tensors it launches the kernel on torch.cuda.current_stream()
and raises when the launch fails; it takes the plain versions
(ops/hitgen._resolve_chains, _resolve_chains_recover) only for tensors
on the CPU.  `resolve_chains.launches` counts the kernel's launches and
`resolve_chains.recover_launches` those of them in recover mode.  What
bounds the kernel on the card is noted at the top of its source.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .hitgen import (RESOLVE_CHAIN_CAP, _resolve_chains,
                     _resolve_chains_recover)

_I32 = torch.int32


def resolve_chains(starts, lens, extent_s, start2_s, de0_s, live_s,
                   diag_s=None, da0_s=None):
    """The diagonal-hash drop protocol over a launch's hash-sorted hits,
    each chain walked in order from its head (chain_bounds gives starts
    and lens).  start2_s is pos2 - seed_len of each hit.  Simple mode:
    de0_s is the activated extent at the head (>= 0); returns (alive_s,
    de_before_s, converged).  Recover mode, with diag_s and da0_s:
    de0_s and da0_s are the raw states at the head; returns (alive_s,
    de_before_s, fin_de, fin_da, converged), fin_* per chain."""
    recover = diag_s is not None
    if starts.device.type == "cpu":
        if recover:
            return _resolve_chains_recover(extent_s, start2_s, diag_s,
                                           de0_s, da0_s, starts, lens,
                                           live_s)
        return _resolve_chains(extent_s, start2_s, de0_s, starts, lens,
                               live_s)
    if starts.device.type != "cuda":
        raise ValueError(f"resolve_chains: unsupported device "
                         f"{starts.device}")
    if recover != (da0_s is not None):
        raise ValueError("resolve_chains: recover mode takes both diag_s "
                         "and da0_s")
    H = extent_s.shape[0]
    nch = starts.shape[0]
    if nch == 0 or lens.shape[0] != nch or live_s.dtype != torch.bool:
        raise ValueError("resolve_chains: starts and lens must be one "
                         "nonempty length and live_s bool")
    dev = starts.device
    alive = torch.ones(H, dtype=torch.bool, device=dev)
    de_before = torch.zeros(H, dtype=_I32, device=dev)
    fin = torch.empty((2, nch if recover else 0), dtype=_I32, device=dev)

    def i32(a):
        return a.to(_I32).contiguous()
    st, ln, ext, s2, d0 = map(i32, (starts, lens, extent_s, start2_s,
                                    de0_s))
    dg, a0 = ((i32(diag_s), i32(da0_s)) if recover else (ext, d0))
    lv = live_s.contiguous()
    rc = build.load().resolve_chains_launch(
        st.data_ptr(), ln.data_ptr(), nch, ext.data_ptr(), s2.data_ptr(),
        dg.data_ptr(), lv.data_ptr(), d0.data_ptr(), a0.data_ptr(), H,
        int(recover), RESOLVE_CHAIN_CAP, alive.data_ptr(),
        de_before.data_ptr(), fin[0].data_ptr(), fin[1].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "resolve_chains")
    resolve_chains.launches += 1
    resolve_chains.recover_launches += int(recover)
    converged = bool(lens.max() <= RESOLVE_CHAIN_CAP)
    if recover:
        return alive, de_before, fin[0], fin[1], converged
    return alive, de_before, converged


resolve_chains.launches = 0
resolve_chains.recover_launches = 0
