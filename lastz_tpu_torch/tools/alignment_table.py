#!/usr/bin/env python3
"""Reader for lastz `--format=general[:<fields>]` tabular output
(reference tabular_tools/alignment_table.py, reimplemented).

The table's header line (`#name1  zstart1  end1 ...`) names the
columns; rows become Alignment objects with one attribute per column,
numeric fields converted.  Works as a streaming iterator or can
prefill the whole file; callers declare which columns they require
and may supply aliases (e.g. accept `id%` for `identity`).

Typical use:

    t = AlignmentTable.from_file(open("out.general"),
                                 requiredColumns=["name1", "zstart1",
                                                  "end1", "name2"])
    for a in t:
        print(a.name1, a.zstart1, a.end1)
"""

from __future__ import annotations

import sys

_INT_COLUMNS = {
    "zstart1", "end1", "start1", "zstart2", "end2", "start2",
    "zstart2+", "end2+", "start2+", "size1", "size2", "nmatch",
    "nmismatch", "ngap", "cgap", "score", "length1", "length2",
    "nlower", "nupper", "ngap1", "ngap2",
}
_FLOAT_COLUMNS = {"identity", "id%", "coverage", "cov%", "continuity",
                  "con%", "blastid%", "gaprate%"}


class Alignment:
    """One table row; attributes are set from the column names (with
    non-identifier characters mapped to '_')."""

    __slots__ = ("__dict__",)

    def __repr__(self):
        inner = " ".join(f"{k}={v}" for k, v in vars(self).items())
        return f"Alignment({inner})"


def _attr_name(col: str) -> str:
    out = "".join(ch if (ch.isalnum() or ch == "_") else "_"
                  for ch in col)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _convert(col: str, text: str):
    base = col.rstrip("%").rstrip("+")
    if col in _INT_COLUMNS or base in _INT_COLUMNS:
        try:
            return int(text)
        except ValueError:
            pass
    if col in _FLOAT_COLUMNS or base in _FLOAT_COLUMNS:
        try:
            if "/" in text:  # identity fraction "970/1000"
                num, den = text.split("/", 1)
                return int(num) / max(int(den), 1)
            return float(text.rstrip("%"))
        except ValueError:
            pass
    return text


class AlignmentTable:
    """Iterate Alignment rows from a general-format file or stream."""

    def __init__(self, source, columns, column_map, prefill):
        self._source = source
        self.columns = columns
        self._column_map = column_map
        self.header = "\t".join(columns) if columns else None
        self.alignments = None
        if prefill:
            self.alignments = list(self._rows())

    # -- construction -----------------------------------------------------

    @classmethod
    def from_file(cls, f, preFill=False, columnNames=None,
                  requiredColumns=None, nonRequiredColumns=None,
                  columnAliases=None):
        """Create a table from an open file/stream.

        columnNames: use these names instead of a '#' header line.
        requiredColumns: error unless all are present (aliases count).
        columnAliases: {alias: canonical} applied to header names.
        """
        if isinstance(f, str):
            f = open(f)
        it = iter(f)
        columns = list(columnNames) if columnNames else None
        first_row = None
        for line in it:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("#"):
                if columns is None:
                    columns = line[1:].strip().split()
                continue
            first_row = line
            break
        if columns is None:
            raise ValueError(
                "alignment table has no header line and no "
                "columnNames were given")
        aliases = dict(columnAliases or {})
        columns = [aliases.get(c, c) for c in columns]
        if requiredColumns:
            missing = [c for c in requiredColumns if c not in columns]
            if missing:
                raise ValueError(
                    "alignment table lacks required column(s): "
                    + ",".join(missing))
        if nonRequiredColumns:
            known = set(requiredColumns or []) | set(nonRequiredColumns)
            unknown = [c for c in columns if c not in known]
            if unknown:
                raise ValueError(
                    "alignment table has unsupported column(s): "
                    + ",".join(unknown))
        column_map = [(c, _attr_name(c)) for c in columns]

        def source():
            if first_row is not None:
                yield first_row
            for ln in it:
                ln = ln.rstrip("\n")
                if ln.strip() and not ln.startswith("#"):
                    yield ln

        return cls(source(), columns, column_map, preFill)

    # -- iteration --------------------------------------------------------

    def _rows(self):
        for line in self._source:
            fields = line.split("\t")
            if len(fields) == 1:
                fields = line.split()
            if len(fields) != len(self.columns):
                raise ValueError(
                    f"bad alignment table row (expected "
                    f"{len(self.columns)} fields): {line!r}")
            a = Alignment()
            for (col, attr), text in zip(self._column_map, fields):
                setattr(a, attr, _convert(col, text))
            a.line = line
            yield a

    def __iter__(self):
        if self.alignments is not None:
            return iter(self.alignments)
        return self._rows()


# -- small aids (reference alignment_table_aids.py) -------------------------


def intervals_overlap(s1, e1, s2, e2) -> bool:
    """Half-open interval overlap."""
    return s1 < e2 and s2 < e1


def alignment_length(a) -> int:
    return int(a.end1) - int(getattr(a, "zstart1", a.end1))


def group_by(table, key):
    """Group alignments by a key attribute, preserving first-seen
    order of the groups."""
    groups: dict = {}
    for a in table:
        groups.setdefault(getattr(a, key), []).append(a)
    return groups


def main(argv=None):
    """Filter/echo a table: alignment_table.py [--require=col[,col]]
    reads a general-format table on stdin and echoes valid rows."""
    argv = argv if argv is not None else sys.argv[1:]
    required = []
    for arg in argv:
        if arg.startswith("--require="):
            required = arg.split("=", 1)[1].split(",")
        else:
            raise SystemExit(f"unknown option {arg}")
    t = AlignmentTable.from_file(sys.stdin,
                                 requiredColumns=required or None)
    if t.header:
        print("#" + t.header)
    for a in t:
        print(a.line)


if __name__ == "__main__":
    main()
