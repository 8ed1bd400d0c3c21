"""Split a fasta file into overlapping fragments (the reference
tools/fasta_fragments.py capability, reimplemented).

    python -m lastz_tpu_torch.tools.fasta_fragments [options] < in.fa > out.fa
      --fragment=<length>   fragment length      (default 100)
      --step=<length>       start-to-start step  (default 50)
      --shuffle[=<seed>]    shuffle output order
      --origin=<zero|one>   header coordinate origin (default one)
      --head=<n>            output at most n fragments
"""

from __future__ import annotations

import random
import sys


def fragments(records, fragment=100, step=50, origin_one=True):
    for name, seq in records:
        n = len(seq)
        for start in range(0, max(n - fragment, 0) + 1, step):
            frag = seq[start : start + fragment]
            if len(frag) < fragment:
                break
            pos = start + 1 if origin_one else start
            # the reference tool uppercases fragments (soft-masking is
            # not meaningful for shredded reads)
            yield f"{name}_{pos}", frag.upper()


def read_fasta(f):
    name = None
    chunks = []
    for line in f:
        line = line.strip()
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(chunks)
            name = line[1:].split()[0] if line[1:].split() else ""
            chunks = []
        elif line:
            chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    fragment, step = 100, 50
    shuffle = None
    origin_one = True  # the reference tool names fragments origin-1
    head = None
    for arg in argv:
        if arg.startswith("--fragment="):
            fragment = int(arg.split("=", 1)[1])
        elif arg.startswith("--step="):
            step = int(arg.split("=", 1)[1])
        elif arg == "--shuffle":
            shuffle = random.Random()
        elif arg.startswith("--shuffle="):
            shuffle = random.Random(int(arg.split("=", 1)[1]))
        elif arg == "--origin=one":
            origin_one = True
        elif arg == "--origin=zero":
            origin_one = False
        elif arg.startswith("--head="):
            head = int(arg.split("=", 1)[1])
        else:
            print(__doc__, file=sys.stderr)
            return 1
    out = list(fragments(read_fasta(sys.stdin), fragment, step, origin_one))
    if shuffle is not None:
        shuffle.shuffle(out)
    if head is not None:
        out = out[:head]
    for name, frag in out:
        sys.stdout.write(f">{name}\n{frag}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
