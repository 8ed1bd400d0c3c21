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

The one array whose life the program controls, the run's target, goes
by a handle instead (`TargetState`, one per Pipeline.run): it holds the
target and its table, so no freed array can alias them, and a
generation that the only writers of either (dynamic masking, the chore
fences) bump through `TargetState.mark` before they write.  A stage
that holds the handle finds its copies with no digest and no pass over
the target; a copy older than the generation is patched where the
target changed.  RunStats counts "target reuses", "target builds",
"target patches" and "target patch bytes".

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
import weakref
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
# the live TargetStates, whose copies release_stream drops too
_HANDLES = weakref.WeakSet()
TARGET_COUNTERS = ("target reuses", "target builds", "target patches",
                   "target patch bytes")


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
        handles = list(_HANDLES)
    for h in handles:
        h.release(sk)


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


def _up(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


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
        return dict(
            csr_start=_up(pt.csr_start, np.int32, device),
            csr_pos=_up(pt.csr_pos, np.int32, device),
            alive=(_up(pt.alive, np.uint8, device) if pt.alive is not None
                   else None))
    arrs = _cached(device, key, make)
    return dict(arrs, adj_start=int(pt.adj_start), step=int(pt.step))


class _Copy:
    """A TargetState's device copy: `made` (a tensor, or a table's dict
    of tensors), what it was made from (`of`: the code_map's bytes, or
    the table's host arrays), the generation it is current at, and
    whether the tensor a patch writes (the codes, the table's alive)
    is still the content-keyed cache's (`shared`)."""

    __slots__ = ("gen", "of", "made", "shared")

    def __init__(self, gen, of, made):
        self.gen = gen
        self.of = of
        self.made = made
        self.shared = True


class TargetState:
    """The run's target on the device, for every stage and strand of
    one Pipeline.run: the target's bytes `v` and its position table
    `pt`, held by reference; the count of each byte code in `v`, made
    at first use; a `generation`; and, per stream (stream_key), the
    copies made of them: the padded codes for each (pad, dtype), under
    one code_map at a time, and a host table's CSR arrays (a table
    built on the device is used in place, as upload_position_table
    does).  A stage whose sequence `is` the handle's `v` asks the handle
    and not the content-keyed cache: no digest, no pass over the target.
    A copy is built once through that cache (upload_codes,
    upload_position_table), so a run finds what an earlier run of the
    same target uploaded, for one digest.

    Whatever writes `v` or `pt` during the run calls `mark(beg, end,
    cleared)` first: bytes [beg, end) of `v` are about to change, and
    the table's entries `cleared` were cleared.  That write is done
    before the next mark or lookup.  A lookup brings an older copy up
    to date: the codes of the changed bytes are written again and the
    cleared entries cleared; a code_map changed by the new bytes builds
    the codes again, in place of the old copy.  A copy is cloned before
    its first patch, so that the cache's tensor keeps the content its
    key names."""

    def __init__(self, v, pt=None):
        self.v = v
        self.pt = pt
        self.generation = 0
        self._counts = None
        # the interval whose write the last mark announced
        self._pending = None
        # (generation, beg, end, cleared) newer than the oldest copy
        self._log = []
        self._copies: dict = {}
        self._lock = threading.Lock()
        with _CACHE_LOCK:
            _HANDLES.add(self)
        # --stats shows the handle's counters from the start, at 0
        for k in TARGET_COUNTERS:
            stats.current.add(k, 0)

    def mark(self, beg: int, end: int, cleared=None) -> None:
        """Bytes [beg, end) of `v` are about to be written, and the
        table's entries `cleared` (indices into its csr_pos) were
        cleared."""
        with self._lock:
            self._settle()
            if self._counts is not None:
                self._counts -= np.bincount(self.v[beg:end], minlength=256)
                self._pending = (beg, end)
            self.generation += 1
            if self._copies:
                self._log.append((self.generation, beg, end, cleared))

    def present(self) -> np.ndarray:
        """present_codes(v), from the counts kept."""
        with self._lock:
            if self._counts is None:
                self._counts = np.bincount(self.v, minlength=256)
            self._settle()
            return self._counts > 0

    def codes(self, code_map, device, pad: int = 0,
              dtype=np.int8) -> torch.Tensor:
        """upload_codes(v, code_map, device, pad, dtype)."""
        dtype = np.dtype(dtype)
        key = ("codes", pad, dtype.str)
        cmap = code_map.tobytes()
        st = stats.current
        with self._lock:
            mine = self._copies.setdefault(stream_key(device), {})
            c = mine.get(key)
            if c is None or c.of != cmap:
                c = mine[key] = _Copy(
                    self.generation, cmap,
                    upload_codes(self.v, code_map, device, pad, dtype))
                self._built(st)
            elif c.gen != self.generation:
                if c.shared:
                    c.made, c.shared = c.made.clone(), False
                idx = self._changed(c.gen)
                vals = code_map[self.v[idx]].astype(dtype)
                c.made[_up(idx + pad, np.int64, device)] = \
                    torch.from_numpy(vals).to(device)
                self._patched(st, c, idx.nbytes + vals.nbytes)
            else:
                st.add("target reuses")
            return c.made

    def table(self, device) -> dict:
        """upload_position_table(pt, device)."""
        pt = self.pt
        st = stats.current
        if getattr(pt, "in_place", False):
            st.add("target reuses")
            return upload_position_table(pt, device)
        with self._lock:
            mine = self._copies.setdefault(stream_key(device), {})
            c = mine.get("table")
            if (c is None or c.of[0] is not pt.csr_start
                    or c.of[1] is not pt.csr_pos):
                made = upload_position_table(pt, device)
                c = mine["table"] = _Copy(
                    self.generation, (pt.csr_start, pt.csr_pos, pt.alive),
                    {k: made[k] for k in ("csr_start", "csr_pos", "alive")})
                self._built(st)
            elif c.gen != self.generation:
                if c.of[2] is not pt.alive:
                    # the first clearing makes the table's alive array
                    c.made["alive"] = _up(pt.alive, np.uint8, device)
                    c.of = (*c.of[:2], pt.alive)
                    c.shared = False
                    n = _nbytes(c.made["alive"])
                else:
                    idx = self._cleared(c.gen)
                    if len(idx):
                        if c.shared:
                            c.made["alive"] = c.made["alive"].clone()
                            c.shared = False
                        c.made["alive"][_up(idx, np.int64, device)] = 0
                    n = idx.nbytes
                self._patched(st, c, n)
            else:
                st.add("target reuses")
            return dict(c.made, adj_start=int(pt.adj_start),
                        step=int(pt.step))

    def release(self, sk) -> None:
        """Drop the copies of the stream `sk` (release_stream)."""
        with self._lock:
            self._copies.pop(sk, None)
            self._trim()

    # -- under the lock ---------------------------------------------------

    def _settle(self) -> None:
        """Count the bytes the last announced write put in."""
        if self._pending is not None:
            beg, end = self._pending
            self._counts += np.bincount(self.v[beg:end], minlength=256)
            self._pending = None

    def _changed(self, gen) -> np.ndarray:
        """Positions of `v` written since generation `gen`."""
        runs = [np.arange(b, e, dtype=np.int64)
                for g, b, e, _ in self._log if g > gen]
        return np.unique(np.concatenate([np.zeros(0, np.int64)] + runs))

    def _cleared(self, gen) -> np.ndarray:
        """Table entries cleared since generation `gen`."""
        runs = [np.asarray(cl, np.int64)
                for g, _, _, cl in self._log if g > gen and cl is not None]
        return np.concatenate([np.zeros(0, np.int64)] + runs)

    def _built(self, st) -> None:
        st.add("target builds")
        self._trim()

    def _patched(self, st, c, n) -> None:
        c.gen = self.generation
        st.add("target patches")
        st.add("target patch bytes", n)
        st.add("upload bytes", n)
        self._trim()

    def _trim(self) -> None:
        """Forget the writes every copy has taken in."""
        oldest = min((c.gen for mine in self._copies.values()
                      for c in mine.values()), default=self.generation)
        self._log = [e for e in self._log if e[0] > oldest]


def carry_state(seq1, seq2, sub, device, pt=None,
                target: TargetState | None = None) -> dict | None:
    """Everything the seed stage's device search reads, built once on
    the host: the compact alphabet of the two sequences (code_map,
    subsmall), the SEQ_PAD-padded codes seq1p/seq2p, and with `pt` the
    position-table CSR.  Returns None when the sequences use more than
    16 codes.  Where `seq1` is the run's target (`target.v`), its
    present codes, codes and table (where `pt` is `target.pt`) come
    from the handle; every other array goes by content.  The target's
    part is timed as "hitgen setup target", the query's as "hitgen
    setup query"."""
    st = stats.current
    if target is not None and target.v is not seq1:
        target = None
    with st.time("hitgen setup target"):
        target_codes = (target.present() if target is not None
                        else present_codes(seq1))
    with st.time("hitgen setup query"):
        cmap = compact_alphabet([target_codes, present_codes(seq2)], sub,
                                max_k=16)
    if cmap is None:
        return None
    code_map, subsmall = cmap
    state = dict(code_map=code_map, subsmall=subsmall,
                 subsmall_t=torch.from_numpy(subsmall).to(device))
    with st.time("hitgen setup target"):
        if target is not None:
            state["seq1p"] = target.codes(code_map, device, SEQ_PAD)
        else:
            state["seq1p"] = upload_codes(seq1, code_map, device, SEQ_PAD)
        if pt is not None:
            state.update(target.table(device)
                         if target is not None and target.pt is pt
                         else upload_position_table(pt, device))
    with st.time("hitgen setup query"):
        state["seq2p"] = upload_codes(seq2, code_map, device, SEQ_PAD)
    return state
