"""Target capsule: a persisted, memory-mappable index snapshot.

The reference capsule (capsule.c:6-15) writes the target sequence, its
reverse, the seed position table and the seed into one binary file;
readers mmap it read-only so many processes on a host share physical
memory.  The TPU-native equivalent keeps the same contract -- build
the index once, share it -- but stores our CSR position table
(index/postable.py) instead of the reference's last/prev linked lists,
and is the natural unit to broadcast to device HBM once per host.

File layout: magic, 8-byte little-endian header length, a JSON header
(sequence metadata, seed pattern, array directory), then raw
little-endian array blocks, each 64-byte aligned.  Readers np.memmap
each block, so pages are shared copy-on-write across processes exactly
like the reference's mmap (capsule.c:668).
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from ..core.seeds import parse_seed, seed_pattern_string
from ..io.sequence import Sequence, Partition
from .postable import DevicePositionTable, PositionTable

MAGIC = b"#LASTZ_TPU_capsule_v1\n"
_ALIGN = 64


def _aligned(offset: int) -> int:
    return (offset + _ALIGN - 1) & ~(_ALIGN - 1)


def write_capsule_file(path: str, target: Sequence,
                       pt: PositionTable) -> int:
    """Write target + position table; returns total bytes written
    (reference write_capsule_file, capsule.c:182)."""
    def compact(a):
        # 4-byte entries on disk when they fit, matching the reference's
        # 4*(L + 4^W) memory model (lastz.c:58-63)
        a = np.ascontiguousarray(a)
        if a.dtype.itemsize > 4 and a.size and 0 <= a.min() \
                and a.max() <= 0xFFFFFFFF:
            return a.astype(np.uint32)
        return a

    arrays = {
        "target_v": np.ascontiguousarray(target.v),
        "csr_start": compact(pt.csr_start),
        "csr_pos": compact(pt.csr_pos),
    }
    if pt.csr_resolve is not None:
        arrays["csr_resolve"] = np.ascontiguousarray(pt.csr_resolve)
    if target.vq is not None:
        arrays["target_vq"] = np.ascontiguousarray(target.vq)

    meta = {
        "sequence": {
            "filename": target.filename,
            "header": target.header,
            "short_header": target.short_header,
            "start_loc": target.start_loc,
            "true_len": target.true_len,
            "contig": target.contig,
            "file_type": target.file_type,
            "use_full_names": target.use_full_names,
            "partitions": [
                [p.sep_before, p.sep_after, p.header, p.true_len,
                 p.start_loc, p.contig]
                for p in target.partitions
            ],
        },
        "table": {
            "seed_pattern": seed_pattern_string(pt.seed),
            "with_trans": pt.seed.with_trans,
            # re-parsing with the seed's own packed weight as the bit
            # budget reproduces the same demotion for overweight seeds
            "max_index_bits": pt.seed.weight,
            "step": pt.step,
            "start": pt.start,
            "end": pt.end,
            "adj_start": pt.adj_start,
        },
        "arrays": {},
    }

    # lay out the directory
    offset = 0  # relative to the start of the data area
    for name, arr in arrays.items():
        offset = _aligned(offset)
        meta["arrays"][name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
        }
        offset += arr.nbytes

    header = json.dumps(meta).encode()
    preamble = MAGIC + len(header).to_bytes(8, "little") + header
    data_start = _aligned(len(preamble))

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(b"\0" * (data_start - len(preamble)))
        pos = 0
        for name, arr in arrays.items():
            want = meta["arrays"][name]["offset"]
            if want > pos:
                f.write(b"\0" * (want - pos))
                pos = want
            f.write(arr.tobytes())
            pos += arr.nbytes
        total = data_start + pos
    return total


def open_capsule_file(path: str, writable_target: bool = False):
    """Load (Sequence, PositionTable) from a capsule, memory-mapping
    the arrays (reference open_capsule_file, capsule.c:668).  With
    writable_target, the target bytes are copied so dynamic masking
    can overwrite them."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise SystemExit(f'FAILURE: bad capsule file "{path}"'
                             " (wrong magic number)")
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen))
    data_start = _aligned(len(MAGIC) + 8 + hlen)

    def load(name):
        spec = meta["arrays"][name]
        return np.memmap(path, dtype=np.dtype(spec["dtype"]), mode="r",
                         offset=data_start + spec["offset"],
                         shape=tuple(spec["shape"]))

    sq = meta["sequence"]
    v = load("target_v")
    if writable_target:
        v = np.array(v)  # private copy; masking mutates it
    target = Sequence(
        v=v,
        filename=sq["filename"],
        header=sq["header"],
        short_header=sq["short_header"],
        start_loc=sq["start_loc"],
        true_len=sq["true_len"],
        contig=sq["contig"],
        file_type=sq["file_type"],
        use_full_names=sq["use_full_names"],
        partitions=[Partition(*p) for p in sq["partitions"]],
        vq=np.array(load("target_vq")) if "target_vq" in meta["arrays"]
        else None,
    )

    tb = meta["table"]
    seed = parse_seed(tb["seed_pattern"], tb["max_index_bits"],
                      with_trans=tb["with_trans"])
    pt = PositionTable(
        seed=seed,
        step=tb["step"],
        start=tb["start"],
        end=tb["end"],
        adj_start=tb["adj_start"],
        csr_start=load("csr_start"),
        csr_pos=load("csr_pos"),
        csr_resolve=(load("csr_resolve")
                     if "csr_resolve" in meta["arrays"] else None),
    )
    return target, pt


def unitize(v: int, by_thousands: bool = True) -> str:
    """reference unitize (utilities.c:1216): '%.1f' + K/M/G/... suffix."""
    units = ["", "K", "M", "G", "T", "P", "E", "Z"]
    divisor = 1000 if by_thousands else 1024
    sign = "-" if v < 0 else ""
    vv = abs(v)
    rep = float(vv)
    unit = 0
    while vv > 1023:
        vv //= divisor
        rep /= divisor
        unit += 1
    if rep > 99:
        rep /= divisor
        unit += 1
    return f"{sign}{rep:.1f}{units[unit]}"


# ---------------------------------------------------------------------------
# device residency: the analogue of the reference's multi-process mmap
# sharing (capsule.c:6-15) -- the index is loaded from a capsule once
# per process and device, pushed to the device once, then reused across
# queries, strands and runs in the process
# ---------------------------------------------------------------------------


class DeviceIndex:
    """A capsule's seed index on a device: the CSR offset and position
    arrays as int32 tensors (port of lastz_tpu/index/capsule.py:
    202-224, which also kept the target's bytes there; nothing on the
    device reads them).  The position table that open_capsule_to_device
    returns reads its CSR from here."""

    def __init__(self, pt: PositionTable, device):
        import torch

        def up(a):
            return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
        self.csr_start = up(pt.csr_start)
        self.csr_pos = up(pt.csr_pos)


_DEVICE_CACHE: dict = {}
_DEVICE_CACHE_LOCK = threading.Lock()


def open_capsule_to_device(path: str, device):
    """Load a capsule and push its index to `device`, memoized per
    (path, mtime) and device so that repeated runs in one process reuse
    the same device copy (port of lastz_tpu/index/capsule.py:227-241;
    reference capsule_position_table, capsule.c:668).  Returns (target,
    pt, dev): pt is a DevicePositionTable over dev's tensors, with the
    capsule's mapped arrays as its host copies.  An entry is built once,
    under a lock, and its uploading stream synchronized, so that any
    thread's stream may read it."""
    from ..device import resolve_device
    device = resolve_device(device)
    key = (os.path.abspath(path), os.stat(path).st_mtime_ns, str(device))
    with _DEVICE_CACHE_LOCK:
        hit = _DEVICE_CACHE.get(key)
        if hit is None:
            hit = _DEVICE_CACHE[key] = _capsule_to_device(path, device)
    return hit


def _capsule_to_device(path: str, device):
    import torch
    target, host = open_capsule_file(path)
    if len(host.csr_pos) >= (1 << 31):
        raise ValueError(f"capsule {path}: {len(host.csr_pos)} index "
                         "entries do not fit int32 offsets")
    dev = DeviceIndex(host, device)
    pt = DevicePositionTable(
        seed=host.seed, step=host.step, start=host.start, end=host.end,
        adj_start=host.adj_start, dev_csr_start=dev.csr_start,
        dev_csr_pos=dev.csr_pos, n_entries=len(host.csr_pos),
        csr_resolve=host.csr_resolve, host_start=host.csr_start,
        host_pos=host.csr_pos)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return target, pt, dev
