#!/usr/bin/env python3
"""Select sequences from an hsx-indexed fasta (reference
tools/pick_from_fasta_hsx.py + tools/hsx_file.py get_sequence).

usage: pick_from_fasta_hsx hsx_file [--names=<file>] [name1 name2 ...]
"""

import sys

from .hsx import read_hsx

USAGE = """
pick_from_fasta_hsx hsx_file [--names=<file>] [name1 name2 ...]
  --names=<file>  read sequence names from a file
  --nowarn        don't warn about sequences that aren't found
"""


def fetch_sequence(index, name):
    """Return the fasta record text ('>' header + sequence lines, joined
    by newlines) for `name`, or None (hsx_file.py:174-252)."""
    entry = index.lookup(name)
    if entry is None:
        return None
    path = index.resolve_file(entry.file_num)
    lines = []
    seq_read = 0
    with open(path) as f:
        f.seek(entry.offset)
        while True:
            line = f.readline()
            if line == "":
                break
            line = line.strip()
            if line.startswith(">"):
                if lines:
                    break
                lines.append(line)
                continue
            seq_read += len(line)
            if seq_read > entry.length:
                line = line[: entry.length - seq_read]
                seq_read = entry.length
            lines.append(line)
            if seq_read == entry.length:
                break
    if seq_read != entry.length:
        raise SystemExit("sequence for %s is short (%d < %d)"
                         % (name, seq_read, entry.length))
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    hsx_name = None
    names = []
    warn = True
    for arg in argv:
        val = arg.split("=", 1)[1] if "=" in arg else None
        if arg in ("--help", "-h", "--h", "-help"):
            raise SystemExit(USAGE)
        elif arg.startswith("--names=") and val:
            with open(val) as f:
                names += [ln.strip() for ln in f]
        elif arg == "--nowarn":
            warn = False
        elif arg.startswith("--"):
            raise SystemExit("unknown argument: %s\n%s" % (arg, USAGE))
        elif hsx_name is None:
            hsx_name = arg
        else:
            names.append(arg)
    if hsx_name is None:
        raise SystemExit("you must give me an hsx file!\n" + USAGE)
    if not names:
        raise SystemExit("you must give me some sequence names!\n" + USAGE)

    index = read_hsx(hsx_name)
    for name in names:
        seq = fetch_sequence(index, name)
        if seq is not None:
            print(seq)
        elif warn:
            print("WARNING: %s not found" % name, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
