"""Sort MAF alignment blocks by a key (the reference tools/maf_sort.py
capability, reimplemented).

    python -m lastz_tpu_torch.tools.maf_sort --key=[-]<key> < in.maf > out.maf
keys: score beg1 beg2 end1 end2 diag name1 name2 pos1 pos2
('-' prefix reverses the order)
"""

from __future__ import annotations

import sys


def parse_blocks(text: str):
    """Yields (header_lines, [(key_fields, block_lines, comments)]).

    header_lines: leading comments before the first block.
    """
    lines = text.splitlines()
    header = []
    blocks = []
    comments = []
    i = 0
    seen_block = False
    while i < len(lines):
        line = lines[i]
        if line.startswith("a "):
            seen_block = True
            block = [line]
            i += 1
            while i < len(lines) and lines[i].strip():
                block.append(lines[i])
                i += 1
            blocks.append((block, comments))
            comments = []
        elif not seen_block:
            header.append(line)
            i += 1
        else:
            if line.strip():
                comments.append(line)
            i += 1
    return header, blocks


def block_key(block, key: str):
    """Full composite sort keys, matching the reference tool's tuples
    (tools/maf_sort.py:148-170)."""
    s_lines = [l for l in block if l.startswith("s ")]
    s1 = s_lines[0].split()
    s2 = s_lines[1].split() if len(s_lines) > 1 else s1
    score = float(block[0].split("score=")[1].split()[0])
    name1, pos1, len1, strand1 = s1[1], int(s1[2]), int(s1[3]), s1[4]
    name2, pos2, len2, strand2 = s2[1], int(s2[2]), int(s2[3]), s2[4]
    if key == "score":
        return (score, pos1, strand1, pos2, strand2, len1, len2,
                name1, name2)
    if key in ("pos1", "beg1"):
        return (pos1, strand1, pos2, strand2, len1, len2, score,
                name1, name2)
    if key in ("pos2", "beg2"):
        return (pos2, strand2, pos1, strand1, len2, len1, score,
                name1, name2)
    if key == "end1":
        return (pos1 + len1, strand1, pos2 + len2, strand2, len1, len2,
                score, name1, name2)
    if key == "end2":
        return (pos2 + len2, strand2, pos1 + len1, strand1, len2, len1,
                score, name1, name2)
    if key == "diag":
        return (strand1, strand2, pos1 - pos2, pos1, len1, len2, score,
                name1, name2)
    if key == "name1":
        return (name1, score, len1, strand1, pos1, name2, len2,
                strand2, pos2)
    if key == "name2":
        return (name2, score, len2, strand2, pos2, name1, len1,
                strand1, pos1)
    raise SystemExit(f"unknown key: {key}")


def sort_maf(text: str, key: str = "pos1", reverse: bool = False) -> str:
    header, blocks = parse_blocks(text)
    keyed = [(block_key(b, key), b, c) for b, c in blocks]
    keyed.sort(key=lambda t: t[0], reverse=reverse)
    out = list(header)
    for _, block, comments in keyed:
        out.extend(comments)
        out.extend(block)
        out.append("")
    return "\n".join(out) + ("\n" if out else "")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    key = None
    for arg in argv:
        if arg.startswith("--key="):
            key = arg.split("=", 1)[1]
        else:
            print("maf_sort --key=[-]<score|beg1|beg2|end1|end2|diag|"
                  "name1|name2|pos1|pos2> < maf_file > maf_file",
                  file=sys.stderr)
            return 1
    if key is None:
        print("you must specify a sort key", file=sys.stderr)
        return 1
    reverse = key.startswith("-")
    if reverse:
        key = key[1:]
    sys.stdout.write(sort_maf(sys.stdin.read(), key, reverse))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
