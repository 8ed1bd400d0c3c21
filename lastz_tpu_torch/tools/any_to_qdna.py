#!/usr/bin/env python3
"""Wrap arbitrary bytes as a LASTZ qdna file (reference
tools/any_to_qdna.py).

usage: any_to_qdna [--name=<string>] [--striplinebreaks] [--simple]
                   < any_file > qdna_file

The version-2 layout (reference tools/any_to_qdna.py:8-18; read back by
our io/sequence.py _read_qdna): big-endian magic C4B47197, version,
header length 20, sequence offset, name offset (0 = unnamed), sequence
length, properties offset (unused).  --simple emits only the old-style
magic F656659E followed by the raw bytes.
"""

import struct
import sys

QDNA_OLD_MAGIC = 0xF656659E
QDNA_MAGIC = 0xC4B47197
QDNA_VERSION = 0x00000200

USAGE = """any_to_qdna [options] < any_file > qdna_file
  Convert any file to a LASTZ quantum dna file.

  options:
    --name=<string>    the name of the sequence
                       (by default, the sequence is unnamed)
    --striplinebreaks  strip line breaks from the file
                       (default is to include line breaks in the qdna file)
    --simple           create an "old-style" qdna file
                       (default is to create a version 2 qda file)"""


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    name = None
    strip = False
    simple = False
    for arg in argv:
        if arg in ("--help", "-h", "--h", "-help"):
            raise SystemExit(USAGE)
        elif arg.startswith("--name="):
            name = arg.split("=", 1)[1]
        elif arg in ("--striplinebreaks", "--strip"):
            strip = True
        elif arg in ("--simple", "--old"):
            simple = True
        else:
            raise SystemExit(f"can't understand {arg}\n{USAGE}")
    if simple and name is not None:
        raise SystemExit("simple qdna file cannot carry a sequence name")

    data = sys.stdin.buffer.read()
    if strip:
        data = b"".join(data.splitlines())

    out = sys.stdout.buffer
    if simple:
        out.write(struct.pack(">I", QDNA_OLD_MAGIC))
        out.write(data)
        return 0

    header_len = 20
    if name is None:
        name_offset = 0
        seq_offset = header_len + 8
    else:
        name_offset = header_len + 8
        seq_offset = name_offset + len(name) + 1
    out.write(struct.pack(">IIIIII", QDNA_MAGIC, QDNA_VERSION, header_len,
                          seq_offset, name_offset, len(data)))
    out.write(struct.pack(">I", 0))
    if name is not None:
        out.write(name.encode("latin-1") + b"\0")
    out.write(data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
