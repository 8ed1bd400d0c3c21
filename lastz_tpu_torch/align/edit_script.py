"""Edit scripts and gapped alignments.

The reference stores alignments as run-length-encoded op lists
(edit_script.c: 2-bit op + 30-bit repeat).  Here an EditScript is a
list of (op, run) with op in {'S','I','D'}:
  'S' — substitution column (advance both sequences)
  'I' — insertion (gap in target; advance query / seq2)
  'D' — deletion (gap in query; advance target / seq1)
Consecutive same ops are merged on append.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class EditScript:
    ops: List[Tuple[str, int]] = field(default_factory=list)

    def add(self, op: str, run: int):
        if run <= 0:
            return
        if self.ops and self.ops[-1][0] == op:
            self.ops[-1] = (op, self.ops[-1][1] + run)
        else:
            self.ops.append((op, run))

    def append_script(self, other: "EditScript"):
        for op, run in other.ops:
            self.add(op, run)

    def reversed(self) -> "EditScript":
        s = EditScript()
        for op, run in reversed(self.ops):
            s.add(op, run)
        return s

    def mirrored(self) -> "EditScript":
        """Swap roles of the two sequences (I <-> D)."""
        swap = {"S": "S", "I": "D", "D": "I"}
        return EditScript([(swap[op], run) for op, run in self.ops])

    def lengths(self) -> Tuple[int, int]:
        n1 = sum(r for op, r in self.ops if op in ("S", "D"))
        n2 = sum(r for op, r in self.ops if op in ("S", "I"))
        return n1, n2

    def num_gap_columns(self) -> int:
        return sum(r for op, r in self.ops if op != "S")

    def num_gaps(self) -> int:
        return sum(1 for op, r in self.ops if op != "S")


@dataclass
class Alignment:
    beg1: int  # origin-1 start in target
    beg2: int  # origin-1 start in query (strand coordinates)
    end1: int  # origin-1 inclusive end
    end2: int
    script: EditScript
    score: int
    seg_id: int = 0
    hsp_id: int = 0
    is_trivial: bool = False

    def hash_key(self) -> int:
        """Dedup hash (reference alignment_hash semantics: positions
        + script shape)."""
        return hash((self.beg1, self.beg2, self.end1, self.end2,
                     tuple(self.script.ops)))
