"""Device choice and the host-built state the port carries onto it.

The device comes from LASTZ_TORCH_DEVICE: `cuda` (the default) or
`cpu`.  Asking for `cuda` where torch sees no card raises; nothing
falls back to the CPU quietly.  On `cpu` every kernel wrapper runs its
plain PyTorch version, which is how the tests run the port.

`carry_state` is the one place where the host-built numpy state
becomes device tensors: the CSR seed position table, the compact
alphabet and the SEQ_PAD-padded sequence codes
(lastz_tpu/search/device_hits.py:93-161).  Uploads are cached by a
digest of their content, never by id() or data_ptr(): a freed array's
id can be reused by the other strand's sequence.  A position table
built on the device is already there and is used in place.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from .ops.ydrop_exact import make_compact_alphabet

ENV_DEVICE = "LASTZ_TORCH_DEVICE"

# sentinel zeros on both sides of a padded sequence (the value of
# lastz_tpu/ops/hitgen.py:55, kept so both packages share one layout)
SEQ_PAD = 20608

_CACHE: dict = {}
_CACHE_MAX = 8


def get_device() -> torch.device:
    name = os.environ.get(ENV_DEVICE, "cuda")
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(
            f"{ENV_DEVICE} must be 'cuda' or 'cpu', not {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{ENV_DEVICE}=cuda but torch finds no CUDA device; set "
            f"{ENV_DEVICE}=cpu to run the plain PyTorch versions")
    return torch.device("cuda")


def content_key(*arrays) -> str:
    """Digest of the arrays' dtypes, shapes and bytes."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        if a is None:
            h.update(b"none")
            continue
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.data)
    return h.hexdigest()


def _cached(key, make):
    hit = _CACHE.get(key)
    if hit is None:
        if len(_CACHE) >= _CACHE_MAX:
            _CACHE.clear()
        hit = _CACHE[key] = make()
    return hit


def upload_codes(seq, code_map, device, pad: int = 0) -> torch.Tensor:
    """Compact-alphabet codes of `seq` as int8 on `device`, with `pad`
    zeros on both sides."""
    key = ("codes", content_key(seq, code_map), pad, str(device))

    def make():
        host = np.zeros(len(seq) + 2 * pad, np.int8)
        host[pad:pad + len(seq)] = code_map[seq]
        return torch.from_numpy(host).to(device)
    return _cached(key, make)


def upload_position_table(pt, device) -> dict:
    """The CSR arrays of a PositionTable as int32 tensors on `device`
    (alive as uint8, or None when every entry is alive).  A table built
    on a device (index/postable.DevicePositionTable) is taken as it
    is, with neither a digest nor a fetch of its arrays, while it is
    unchanged since its build (lastz_tpu/search/device_hits.py:93-116);
    a host table is uploaded once and cached by content."""
    if getattr(pt, "in_place", False):
        return dict(csr_start=pt.dev_csr_start.to(device),
                    csr_pos=pt.dev_csr_pos.to(device), alive=None,
                    adj_start=int(pt.adj_start), step=int(pt.step))
    key = ("csr", content_key(pt.csr_start, pt.csr_pos, pt.alive),
           str(device))

    def make():
        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
        return dict(
            csr_start=up(pt.csr_start, np.int32),
            csr_pos=up(pt.csr_pos, np.int32),
            alive=(up(pt.alive, np.uint8) if pt.alive is not None
                   else None))
    arrs = _cached(key, make)
    return dict(arrs, adj_start=int(pt.adj_start), step=int(pt.step))


def carry_state(seq1, seq2, sub, device, pt=None) -> dict | None:
    """Everything the device stages read, built once on the host:
    the compact alphabet of the two sequences (code_map, subsmall), the
    SEQ_PAD-padded codes seq1p/seq2p, and with `pt` the position-table
    CSR.  Returns None when the sequences use more than 16 codes."""
    cmap = make_compact_alphabet([seq1, seq2], sub, max_k=16)
    if cmap is None:
        return None
    code_map, subsmall = cmap
    state = dict(
        code_map=code_map, subsmall=subsmall,
        subsmall_t=torch.from_numpy(subsmall).to(device),
        seq1p=upload_codes(seq1, code_map, device, SEQ_PAD),
        seq2p=upload_codes(seq2, code_map, device, SEQ_PAD))
    if pt is not None:
        state.update(upload_position_table(pt, device))
    return state
