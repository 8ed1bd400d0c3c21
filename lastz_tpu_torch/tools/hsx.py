"""HSX ("hashed sequence index") reading and writing.

Format spec: reference tools/hsx_file.py:7-77 (also sequences.c:34-60).
An .hsx file is an index over one or more fasta files: a hash table of
sequence names pointing into a sequence index table whose entries give
(length, file number, byte offset, name).  lastz uses it as a random-
access, name-addressable query container.

This is a fresh implementation from the documented on-disk layout.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

MAGIC_BIG = 0xD2527095
VERSION = 0x00000100
HEADER_LENGTH = 0x1C
MS_BIT5 = 0x80 << (4 * 8)

HASH_SEED = 0x5C3FC4D3
HASH_MULT = 0x87C10417
M32 = 0xFFFFFFFF


def hassock_hash(data: bytes) -> int:
    """reference hassock_hash (utilities.c:1790): a Murmur2 variant
    processing the key back-to-front."""
    n = len(data)
    h = HASH_SEED ^ n
    ix = n
    while ix >= 4:
        k = (data[ix - 1] | (data[ix - 2] << 8)
             | (data[ix - 3] << 16) | (data[ix - 4] << 24))
        k = (k * HASH_MULT) & M32
        k ^= k >> 24
        k = (k * HASH_MULT) & M32
        h = (h * HASH_MULT) & M32
        h ^= k
        ix -= 4
    if ix >= 3:
        h ^= data[2] << 16
    if ix >= 2:
        h ^= data[1] << 8
    if ix >= 1:
        h ^= data[0]
        h = (h * HASH_MULT) & M32
    h ^= h >> 13
    h = (h * HASH_MULT) & M32
    h ^= h >> 15
    return h


def _pad16(n: int) -> int:
    return (-n) % 16


@dataclass
class HsxEntry:
    name: str
    length: int
    file_num: int
    offset: int  # byte offset of the sequence in its fasta file


@dataclass
class HsxIndex:
    files: list  # [(file_type, base_name)], name may be '' => hsx base
    entries: list  # [HsxEntry] in hash order
    num_buckets: int
    path: str

    def resolve_file(self, file_num: int) -> str:
        ftype, base = self.files[file_num]
        if not base:
            base = os.path.splitext(self.path)[0]
        elif not os.path.isabs(base):
            base = os.path.join(os.path.dirname(self.path) or ".", base)
        return f"{base}.{ftype}"

    def lookup(self, name: str):
        for e in self.entries:
            if e.name == name:
                return e
        return None


def read_hsx(path: str) -> HsxIndex:
    with open(path, "rb") as f:
        raw = f.read()
    magic = struct.unpack(">L", raw[0:4])[0]
    if magic == MAGIC_BIG:
        bo = ">"
    elif struct.unpack("<L", raw[0:4])[0] == MAGIC_BIG:
        bo = "<"
    else:
        raise SystemExit(f'FAILURE: bad hsx file "{path}" (wrong magic)')
    # fields: version, headerLength, FN, FO, HN, HO, SN, SO
    version, header_len, fn, fo, hn, ho, sn = struct.unpack(
        bo + "7L", raw[4:0x20])
    so = struct.unpack(bo + "L", raw[0x20:0x24])[0]
    if (version >> 8) != 1:
        raise SystemExit(
            f'FAILURE: hsx file "{path}" version not supported')

    files = []
    for i in range(fn):
        fio = struct.unpack(bo + "L", raw[fo + 4 * i : fo + 4 * i + 4])[0]
        tl = raw[fio]
        ftype = raw[fio + 1 : fio + 1 + tl].decode()
        p = fio + 1 + tl
        nl = raw[p]
        name = raw[p + 1 : p + 1 + nl].decode()
        files.append((ftype, name))

    # sequence index table: walk SN entries from SO
    entries = []
    p = so
    for _ in range(sn):
        length = int.from_bytes(raw[p : p + 5], "big" if bo == ">" else
                                "little")
        file_num = raw[p + 5]
        offset = int.from_bytes(raw[p + 6 : p + 12], "big" if bo == ">"
                                else "little")
        nl = raw[p + 12]
        name = raw[p + 13 : p + 13 + nl].decode()
        p = p + 13 + nl
        entries.append(HsxEntry(name, length, file_num, offset))
    return HsxIndex(files=files, entries=entries, num_buckets=hn, path=path)


def build_hsx(fasta_paths, out_path, avg_bucket: int = 10,
              num_buckets: int | None = None, anonymous: bool = False):
    """Index one or more fasta files into an .hsx (the reference's
    tools/build_fasta_hsx.py capability, reimplemented)."""
    if isinstance(fasta_paths, str):
        fasta_paths = [fasta_paths]

    sequences = []  # (name, length, fileNum, offset)
    for file_num, fp in enumerate(fasta_paths):
        with open(fp, "rb") as f:
            data = f.read()
        pos = 0
        name = None
        seq_off = 0
        seq_len = 0
        while pos <= len(data):
            line_end = data.find(b"\n", pos)
            if line_end < 0:
                line_end = len(data)
            line = data[pos:line_end]
            if line.startswith(b">"):
                if name is not None:
                    sequences.append((name, seq_len, file_num, seq_off))
                name = line[1:].split()[0].decode() if line[1:].split() \
                    else ""
                seq_off = pos
                seq_len = 0
            elif name is not None:
                seq_len += len(line.strip())
            pos = line_end + 1
            if line_end == len(data):
                break
        if name is not None:
            sequences.append((name, seq_len, file_num, seq_off))

    if num_buckets is None:
        num_buckets = max(1, (len(sequences) + avg_bucket - 1) // avg_bucket)

    keyed = sorted(
        (hassock_hash(name.encode()) % num_buckets, name, length, fnum, off)
        for (name, length, fnum, off) in sequences)

    # file info blobs
    file_infos = []
    for fp in fasta_paths:
        base, ext = os.path.splitext(os.path.basename(fp))
        ext = ext.lstrip(".") or "fa"
        name = "" if anonymous else base
        file_infos.append(
            bytes([len(ext)]) + ext.encode()
            + bytes([len(name)]) + name.encode())

    header_size = HEADER_LENGTH + _pad16(8 + HEADER_LENGTH)
    file_table_offset = 0x08 + header_size
    file_table_size = 4 * len(fasta_paths)
    file_table_size += _pad16(file_table_size)
    file_info_offset = file_table_offset + file_table_size
    file_info_len = sum(len(b) for b in file_infos)
    file_info_size = file_info_len + _pad16(file_info_len)
    hash_table_offset = file_info_offset + file_info_size
    hash_table_len = 5 * (num_buckets + 1)
    hash_table_size = hash_table_len + _pad16(hash_table_len)
    seq_table_offset = hash_table_offset + hash_table_size

    # sequence index table entries + their offsets
    seq_blobs = []
    seq_offsets = []
    p = seq_table_offset
    for (_, name, length, fnum, off) in keyed:
        blob = (length.to_bytes(5, "big") + bytes([fnum])
                + off.to_bytes(6, "big") + bytes([len(name)])
                + name.encode())
        seq_offsets.append(p)
        seq_blobs.append(blob)
        p += len(blob)
    end_offset = p

    # hash table: first entry per bucket; empty buckets get the next
    # occupied entry's offset with the MS bit set (spec note 9)
    bucket_first = {}
    for i, (b, *_rest) in enumerate(keyed):
        bucket_first.setdefault(b, seq_offsets[i])
    table = []
    for b in range(num_buckets):
        if b in bucket_first:
            table.append(bucket_first[b])
        else:
            nxt = next((bucket_first[bb] for bb in range(b + 1, num_buckets)
                        if bb in bucket_first), end_offset)
            table.append(nxt | MS_BIT5)
    table.append(end_offset)

    out = bytearray()
    out += struct.pack(">L", MAGIC_BIG)
    out += struct.pack(">L", VERSION)
    out += struct.pack(">L", HEADER_LENGTH)
    out += struct.pack(">L", len(fasta_paths))
    out += struct.pack(">L", file_table_offset)
    out += struct.pack(">L", num_buckets)
    out += struct.pack(">L", hash_table_offset)
    out += struct.pack(">L", len(keyed))
    out += struct.pack(">L", seq_table_offset)
    out += b"\0" * (file_table_offset - len(out))
    fio = file_info_offset
    for blob in file_infos:
        out += struct.pack(">L", fio)
        fio += len(blob)
    out += b"\0" * (file_info_offset - len(out))
    for blob in file_infos:
        out += blob
    out += b"\0" * (hash_table_offset - len(out))
    for v in table:
        out += v.to_bytes(5, "big")
    out += b"\0" * (seq_table_offset - len(out))
    for blob in seq_blobs:
        out += blob

    with open(out_path, "wb") as f:
        f.write(bytes(out))
    return len(out)


def main(argv=None):
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    avg_bucket = 10
    num_buckets = None
    anonymous = False
    paths = []
    out_path = None
    for arg in argv:
        if arg.startswith("--bucketsize="):
            avg_bucket = int(arg.split("=", 1)[1])
        elif arg.startswith("--numbuckets="):
            num_buckets = int(arg.split("=", 1)[1])
        elif arg == "--anonymous":
            anonymous = True
        elif arg.startswith("--out="):
            out_path = arg.split("=", 1)[1]
        else:
            paths.append(arg)
    if not paths or out_path is None:
        print("usage: build_fasta_hsx --out=<file.hsx> fasta [...]",
              file=sys.stderr)
        return 1
    build_hsx(paths, out_path, avg_bucket=avg_bucket,
              num_buckets=num_buckets, anonymous=anonymous)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
