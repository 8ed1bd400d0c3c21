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
built on the device is already there and is used in place.  The run's
RunStats counts the cache's hits and misses, the bytes each miss
copied to the device and the bytes the digests read (--stats).

The farm (parallel/farm.py) runs several pipelines at once, each in
its own thread with its own CUDA stream.  So the upload cache is kept
per (device, stream): an upload is read only on the stream that made
it, and freed only from its own cache, so no stream reads a tensor
another stream is still writing, and none is handed back to the
caching allocator while another stream reads it.  A worker drops its
stream's entries when it ends (release_stream).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from . import stats
from .ops.ydrop_exact import compact_alphabet, present_codes

ENV_DEVICE = "LASTZ_TORCH_DEVICE"

# sentinel zeros on both sides of a padded sequence (the value of
# lastz_tpu/ops/hitgen.py:55, kept so both packages share one layout)
SEQ_PAD = 20608

# (device, stream) -> that stream's uploads, least recently used first
_CACHE: dict = {}
_CACHE_MAX = 8
_CACHE_LOCK = threading.Lock()


def get_device() -> torch.device:
    """LASTZ_TORCH_DEVICE's device, a card with its index resolved
    (the calling thread's current card)."""
    name = os.environ.get(ENV_DEVICE, "cuda")
    if name not in ("cuda", "cpu"):
        raise ValueError(
            f"{ENV_DEVICE} must be 'cuda' or 'cpu', not {name!r}")
    return resolve_device(name)


def resolve_device(name) -> torch.device:
    """torch.device(name) with a card's index resolved: `cuda` is the
    calling thread's current card.  A card that torch does not see
    raises; nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: 'cuda[:i]' or "
                         f"'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{ENV_DEVICE}=cuda but torch finds no CUDA device; set "
            f"{ENV_DEVICE}=cpu to run the plain PyTorch versions")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"{name}: torch sees "
                           f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def stream_key(device) -> tuple:
    """(device, the calling thread's current stream on it): the key of
    the uploads a stream may read.  The CPU has no streams."""
    device = torch.device(device)
    if device.type != "cuda":
        return (str(device), None)
    return (str(device), torch.cuda.current_stream(device).cuda_stream)


def content_key(*arrays) -> str:
    """Digest of the arrays' dtypes, shapes and bytes."""
    h = hashlib.blake2b(digest_size=16)
    n = 0
    for a in arrays:
        if a is None:
            h.update(b"none")
            continue
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.data)
        n += a.nbytes
    stats.current.add("digest bytes", n)
    return h.hexdigest()


def _nbytes(made) -> int:
    """Bytes of an upload: a tensor, or a dict of tensors and None."""
    if isinstance(made, dict):
        return sum(_nbytes(v) for v in made.values())
    return made.numel() * made.element_size() if made is not None else 0


def _cached(device, key, make):
    """The upload `key` on the calling thread's stream of `device`,
    made by make() on a miss; each stream keeps its _CACHE_MAX most
    recently used uploads."""
    sk = stream_key(device)
    st = stats.current
    with _CACHE_LOCK:
        mine = _CACHE.setdefault(sk, OrderedDict())
        hit = mine.get(key)
        if hit is not None:
            mine.move_to_end(key)
            st.add("upload hits")
            return hit
    hit = make()
    st.add("upload misses")
    st.add("upload bytes", _nbytes(hit))
    with _CACHE_LOCK:
        mine = _CACHE.setdefault(sk, OrderedDict())
        mine[key] = hit
        while len(mine) > _CACHE_MAX:
            mine.popitem(last=False)
    return hit


def release_stream(device) -> None:
    """Drop the uploads of the calling thread's stream on `device` (a
    farm worker, after it synchronized that stream)."""
    sk = stream_key(device)
    with _CACHE_LOCK:
        _CACHE.pop(sk, None)


def upload_codes(seq, code_map, device, pad: int = 0,
                 dtype=np.int8) -> torch.Tensor:
    """Compact-alphabet codes of `seq` as `dtype` (int8, or uint8 for
    alphabets past 127 codes) on `device`, with `pad` zeros on both
    sides."""
    key = ("codes", content_key(seq, code_map), pad, np.dtype(dtype).str)

    def make():
        host = np.zeros(len(seq) + 2 * pad, dtype)
        host[pad:pad + len(seq)] = code_map[seq]
        return torch.from_numpy(host).to(device)
    return _cached(device, key, make)


def upload_position_table(pt, device) -> dict:
    """The CSR arrays of a PositionTable as int32 tensors on `device`
    (alive as uint8, or None when every entry is alive).  A table built
    on a device (index/postable.DevicePositionTable) is taken as it
    is, with neither a digest nor a fetch of its arrays, while it is
    unchanged since its build (lastz_tpu/search/device_hits.py:93-116),
    copied once to another card (DevicePositionTable.on); a host table
    is uploaded once a stream and cached by content."""
    if getattr(pt, "in_place", False):
        csr_start, csr_pos = pt.on(device)
        return dict(csr_start=csr_start, csr_pos=csr_pos, alive=None,
                    adj_start=int(pt.adj_start), step=int(pt.step))
    key = ("csr", content_key(pt.csr_start, pt.csr_pos, pt.alive))

    def make():
        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
        return dict(
            csr_start=up(pt.csr_start, np.int32),
            csr_pos=up(pt.csr_pos, np.int32),
            alive=(up(pt.alive, np.uint8) if pt.alive is not None
                   else None))
    arrs = _cached(device, key, make)
    return dict(arrs, adj_start=int(pt.adj_start), step=int(pt.step))


def carry_state(seq1, seq2, sub, device, pt=None) -> dict | None:
    """Everything the seed stage's device search reads, built once on
    the host: the compact alphabet of the two sequences (code_map,
    subsmall), the SEQ_PAD-padded codes seq1p/seq2p, and with `pt` the
    position-table CSR.  Returns None when the sequences use more than
    16 codes.  The target's part (its codes and the table) is timed as
    "hitgen setup target", the query's as "hitgen setup query"."""
    st = stats.current
    with st.time("hitgen setup target"):
        target_codes = present_codes(seq1)
    with st.time("hitgen setup query"):
        cmap = compact_alphabet([target_codes, present_codes(seq2)], sub,
                                max_k=16)
    if cmap is None:
        return None
    code_map, subsmall = cmap
    state = dict(code_map=code_map, subsmall=subsmall,
                 subsmall_t=torch.from_numpy(subsmall).to(device))
    with st.time("hitgen setup target"):
        state["seq1p"] = upload_codes(seq1, code_map, device, SEQ_PAD)
        if pt is not None:
            state.update(upload_position_table(pt, device))
    with st.time("hitgen setup query"):
        state["seq2p"] = upload_codes(seq2, code_map, device, SEQ_PAD)
    return state
