#!/usr/bin/env python3
"""Cigar-string utilities for tabular post-processing (reference
tabular_tools/cigar.py, reimplemented).

Supports both SAM-style cigars (`75M2I30M`, with =/X when mismatches
are marked) and lastz `--format=cigar` op lists (`M 75 I 2 M 30`).
"""

from __future__ import annotations

import re

_SAM_OP = re.compile(r"(\d+)([MIDNSHP=X])")

# op -> (consumes reference/seq1, consumes read/seq2)
OP_CONSUMES = {
    "M": (True, True), "=": (True, True), "X": (True, True),
    "I": (False, True), "S": (False, True),
    "D": (True, False), "N": (True, False),
    "H": (False, False), "P": (False, False),
}


def parse_cigar(text: str):
    """Parse either cigar syntax into [(op, run), ...]."""
    text = text.strip()
    if not text:
        return []
    if " " in text:
        fields = text.split()
        if len(fields) % 2:
            raise ValueError(f"bad cigar: {text!r}")
        out = []
        for op, run in zip(fields[0::2], fields[1::2]):
            if op not in OP_CONSUMES:
                raise ValueError(f"bad cigar op {op!r} in {text!r}")
            out.append((op, int(run)))
        return out
    out = []
    pos = 0
    for m in _SAM_OP.finditer(text):
        if m.start() != pos:
            raise ValueError(f"bad cigar: {text!r}")
        out.append((m.group(2), int(m.group(1))))
        pos = m.end()
    if pos != len(text):
        raise ValueError(f"bad cigar: {text!r}")
    return out


def cigar_to_sam(ops) -> str:
    return "".join(f"{run}{op}" for op, run in ops)


def cigar_lengths(ops):
    """(reference_span, read_span) consumed by the cigar."""
    ref = sum(run for op, run in ops if OP_CONSUMES[op][0])
    read = sum(run for op, run in ops if OP_CONSUMES[op][1])
    return ref, read


def merge_runs(ops):
    """Coalesce adjacent equal ops (and =/X into M)."""
    out = []
    for op, run in ops:
        op = "M" if op in "=X" else op
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + run)
        else:
            out.append((op, run))
    return out


def reverse_cigar(ops):
    return list(reversed(ops))
