#!/usr/bin/env python3
"""Compare two axt files, ignoring trivial differences (reference
tools/axt_compare.py).

usage: axt_compare [--sort] axt_file1 axt_file2

Blocks (a 9-field header line plus the two alignment-text lines) must
match pairwise; --sort first orders both lists by everything except the
axt record number, which is then ignored in the comparison.
"""

import sys

USAGE = """
axt_compare [--sort] axt_file1 axt_file2
"""


def read_axt_blocks(f):
    blocks = []
    block = None
    block_line = 0
    for num, line in enumerate(f, 1):
        line = line.strip()
        if line == "" or line.startswith("#"):
            if block is not None:
                if len(block) != 3:
                    return "bad axt block at line %d" % block_line
                blocks.append((block, block_line))
            block = None
            continue
        if block is None:
            block = []
            block_line = num
        block.append(line)
    if block is not None:
        if len(block) != 3:
            return "bad axt block at line %d" % block_line
        blocks.append((block, block_line))
    return blocks


def convert_block(block):
    info, text1, text2 = block
    return [info.split(), text1, text2]


def sort_blocks(blocks):
    keyed = []
    for block, line_num in blocks:
        new_block = convert_block(block)
        keyed.append((new_block[0][1:], new_block, line_num))
    keyed.sort()
    return [(block, line_num) for _, block, line_num in keyed]


def compare_files(f1, f2, sort_em=False):
    blocks1 = read_axt_blocks(f1)
    if isinstance(blocks1, str):
        return (blocks1, "axt1")
    blocks2 = read_axt_blocks(f2)
    if isinstance(blocks2, str):
        return (blocks2, "axt2")
    if len(blocks1) != len(blocks2):
        return ("different number of blocks", None)
    if sort_em:
        blocks1 = sort_blocks(blocks1)
        blocks2 = sort_blocks(blocks2)
    for (block1, line1), (block2, line2) in zip(blocks1, blocks2):
        if isinstance(block1[0], str):
            block1 = convert_block(block1)
        if isinstance(block2[0], str):
            block2 = convert_block(block2)
        if len(block1[0]) != 9:
            return ("bad axt block at line %d" % line1, "axt1")
        if len(block2[0]) != 9:
            return ("bad axt block at line %d" % line2, "axt2")
        if sort_em:
            block1[0][0] = 0
            block2[0][0] = 0
        if block1 == block2:
            continue
        return "block at line %d vs block at line %d" % (line1, line2)
    return False


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    sort_em = False
    if argv and argv[0] == "--sort":
        sort_em = True
        del argv[0]
    if len(argv) != 2:
        raise SystemExit(USAGE)
    name1, name2 = argv
    with open(name1) as f1, open(name2) as f2:
        different = compare_files(f1, f2, sort_em=sort_em)
    if isinstance(different, tuple):
        message, which = different
        if which == "axt1":
            message = "in %s, %s" % (name1, message)
        elif which == "axt2":
            message = "in %s, %s" % (name2, message)
        different = True
    elif isinstance(different, str):
        message = "%s and %s are different, %s" % (name1, name2, different)
        different = True
    elif different:
        message = "%s and %s are different" % (name1, name2)
    if different:
        print("FAILURE: %s" % message, file=sys.stderr)
        return 1
    print("SUCCESS: %s and %s are equivalent" % (name1, name2),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
