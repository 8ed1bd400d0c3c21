"""Sequence files and the in-memory sequence object.

Host-side reader layer covering the reference's sequences.c surface:
fasta (now), fastq/nib/2bit/hsx (added progressively), bracket actions
(subranges, masks, multi/partitioned, subset, unmask, revcomp), and
the name-shortening rules used by output formats
(reference sequences.c:5854-6040 for shorten_header semantics).

Sequences are numpy uint8 arrays of raw ASCII; partition separators
are NUL bytes, which score VERY_BAD in every score set and therefore
fence all extension stages for free.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.encoding import NUC_TO_COMPLEMENT

# revCompFlags values (reference sequences.h)
RCF_FORWARD = 0
RCF_COMP = 1
RCF_REV = 2
RCF_REVCOMP = 3

NAME_PARSE_CORE = 0
NAME_PARSE_DARKSPACE = 1
NAME_PARSE_ALNUM = 2
NAME_PARSE_FILL_WHITE = 8


@dataclass
class Partition:
    """One contig inside a partitioned ([multi]) sequence."""

    sep_before: int  # index of the NUL byte preceding this contig
    sep_after: int  # index of the NUL byte following this contig
    header: str
    true_len: int
    start_loc: int = 1
    contig: int = 1


@dataclass
class Chore:
    """One alignment chore (reference sequences.h:210-233): restrict
    the pipeline to a (target interval, query interval, strand)."""

    num: int = 1                 # 1-based index among chores on this query
    t_name: str = ""             # "" = wildcard
    t_subrange: bool = False
    t_start: int = 0             # origin-1
    t_end: int = 0               # inclusive end (stored origin-1 closed)
    q_name: str = ""
    q_subrange: bool = False
    q_start: int = 0
    q_end: int = 0
    q_strand: int = 1            # 0: + only, <0: - only, >0: both
    id_tag: str = ""
    # resolved (current-orientation, 0-based half-open) intervals
    target_interval: tuple = (0, 0)
    query_interval: tuple = (0, 0)


def parse_chores_file(path: str):
    """Parse an alignment-chores file (reference read_chore,
    sequences.c:5562+): <name1> <start1> <end1> <name2>
    [<start2> <end2>] [<strand2>] [id=<tag>], '*' wildcards, origin-1
    closed intervals, # comments."""
    chores = []
    try:
        f = open(path)
    except OSError as e:
        raise SystemExit(
            f'FAILURE: failed to open "{path}" for reading ({e.strerror})')
    with f:
        for line_num, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip() if (" #" in raw or
                raw.lstrip().startswith("#")) else raw.strip()
            if not line:
                continue
            fields = line.split()
            if len(fields) < 4:
                raise SystemExit(
                    f"FAILURE: not enough fields in chore"
                    f" ({path}:{line_num}): {line}")
            ch = Chore()
            ch.t_name = "" if fields[0] == "*" else fields[0]
            ix = 3
            if fields[1] != "*":
                ch.t_subrange = True
                ch.t_start = int(fields[1])
                if ch.t_start == 0:
                    raise SystemExit(
                        f"FAILURE: bad chore target start"
                        f" ({path}:{line_num})")
            if fields[2] != "*":
                if not ch.t_subrange:
                    raise SystemExit(
                        f"FAILURE: bad chore target interval"
                        f" ({path}:{line_num})")
                ch.t_end = int(fields[2])
                if ch.t_end <= ch.t_start - 1:
                    raise SystemExit(
                        f"FAILURE: bad chore target interval"
                        f" ({path}:{line_num})")
            elif ch.t_subrange:
                raise SystemExit(
                    f"FAILURE: bad chore target end ({path}:{line_num})")
            ch.q_name = fields[3]
            ix = 4
            if (ix < len(fields) and fields[ix] not in ("+", "-")
                    and not fields[ix].startswith("id=")):
                if ix + 1 >= len(fields):
                    raise SystemExit(
                        f"FAILURE: missing chore query end"
                        f" ({path}:{line_num})")
                qs, qe = fields[ix], fields[ix + 1]
                ix += 2
                if qs != "*":
                    ch.q_subrange = True
                    ch.q_start = int(qs)
                if qe != "*":
                    if not ch.q_subrange:
                        raise SystemExit(
                            f"FAILURE: bad chore query interval"
                            f" ({path}:{line_num})")
                    ch.q_end = int(qe)
                elif ch.q_subrange:
                    raise SystemExit(
                        f"FAILURE: bad chore query end ({path}:{line_num})")
            if ix < len(fields) and fields[ix] in ("+", "-"):
                ch.q_strand = 0 if fields[ix] == "+" else -1
                ix += 1
            if ix < len(fields) and fields[ix].startswith("id="):
                ch.id_tag = fields[ix][3:]
                ix += 1
            if ix < len(fields):
                raise SystemExit(
                    f"FAILURE: extra chore fields ({path}:{line_num}):"
                    f" {line}")
            chores.append(ch)
    return chores


@dataclass
class Sequence:
    v: np.ndarray  # uint8 ASCII; NUL separators if partitioned
    filename: str
    header: str  # raw header line (includes '>' for fasta)
    short_header: str
    start_loc: int = 1  # origin-1 index of v[0] within the file sequence
    true_len: int = 0  # length of the full sequence in the file
    rev_comp_flags: int = RCF_FORWARD
    contig: int = 1  # 1-based record number within the file
    file_type: str = "fasta"
    use_full_names: bool = False
    partitions: list = field(default_factory=list)  # list[Partition]
    vq: Optional[np.ndarray] = None  # quality values (fastq)
    chore: Optional["Chore"] = None
    separator: Optional[str] = None  # [separator=] action (partitioned)

    @property
    def length(self) -> int:
        return len(self.v)

    @property
    def is_partitioned(self) -> bool:
        return bool(self.partitions)

    def rev_comp(self, comp_map=None):
        """Reverse-complement in place (reference rev_comp_sequence).

        Partitioned sequences are reverse-complemented one partition at
        a time, keeping the separator layout (observable in minus-
        strand coordinates, sequences.c rev_comp_sequence).  Quantum
        sequences pass the score file's qToComplement as comp_map."""
        if self.file_type == "qdna" and comp_map is None:
            raise SystemExit(
                f"FAILURE: quantum DNA cannot be complemented"
                f" ({self.filename})\n(the score file lacks complements)")
        if comp_map is None:
            comp_map = NUC_TO_COMPLEMENT
        if self.partitions:
            for part in self.partitions:
                lo, hi = part.sep_before + 1, part.sep_after
                self.v[lo:hi] = comp_map[self.v[lo:hi][::-1]]
        else:
            self.v = comp_map[self.v[::-1]].copy()
        if self.vq is not None:
            self.vq = self.vq[::-1].copy()
        self.rev_comp_flags ^= RCF_REVCOMP

    def lookup_partition(self, pos: int):
        for part in self.partitions:
            if part.sep_before <= pos < part.sep_after:
                return part
        return self.partitions[-1] if self.partitions else None

    def name_for_output(self) -> str:
        return self.header if self.use_full_names else self.short_header


def shorten_header(src: str, name_parse_type: int = NAME_PARSE_CORE,
                   skip_path: bool = False) -> str:
    """Reference shorten_header (sequences.c:5913-6035)."""
    h = src
    if h.startswith(">"):
        h = h[1:]
    h = h.lstrip()
    pfx = "reverse complement of "
    if h.startswith(pfx):
        h = h[len(pfx):].lstrip()
    if h.startswith("positions "):
        rest = h[len("positions "):].lstrip()
        m = re.match(r"\S+\s+", rest)
        if m and rest[m.end():].startswith("of "):
            h = rest[m.end() + 3:].lstrip()
    if skip_path:
        h = h.rsplit("/", 1)[-1]
    h = h.lstrip()
    base = name_parse_type & ~NAME_PARSE_FILL_WHITE
    if base == NAME_PARSE_ALNUM:
        m = re.match(r"[A-Za-z0-9_]*", h)
        out = m.group(0)
        return out
    if base == NAME_PARSE_DARKSPACE:
        m = re.match(r"[^ \t]*", h)
        out = m.group(0)
    else:  # core
        m = re.match(r"[^ \t|:]*", h)
        out = m.group(0)
    for sfx in (".nib", ".2bit", ".hsx", ".fasta", ".fa"):
        if len(out) > len(sfx) and out.endswith(sfx):
            out = out[: -len(sfx)]
            break
    if name_parse_type & NAME_PARSE_FILL_WHITE:
        out = re.sub(r"\s", "_", out)
    return out


_SUBRANGE_RE = re.compile(
    r"^\s*(\d+)\s*(?:(\.\.|,|#)\s*(\d+))?\s*$"
)


def _parse_subrange(text: str):
    """Parse '<start>,<end>' / '<start>..<end>' / '<start>#<len>' forms.

    Returns (start, end) origin-1 inclusive, or None.
    """
    m = _SUBRANGE_RE.match(text)
    if not m:
        return None
    start = int(m.group(1))
    if m.group(3) is None:
        return (start, 0)
    end = int(m.group(3))
    if m.group(2) == "#":
        end = start + end - 1
    return (start, end)


@dataclass
class SequenceSpec:
    """Parsed form of a sequence-file argument with bracket actions."""

    filename: str
    nickname: Optional[str] = None
    contig_of_interest: Optional[str] = None
    names_filename: Optional[str] = None  # subset=
    start: int = 0  # origin-1; 0 => whole
    end: int = 0
    end_is_soft: bool = False
    revcomp: bool = False
    backward: bool = False
    unmask: bool = False
    do_partition: bool = False  # [multi]
    separator: Optional[str] = None
    nmask_filename: Optional[str] = None
    xmask_filename: Optional[str] = None
    softmask_filename: Optional[str] = None
    name_parse_type: int = NAME_PARSE_CORE
    name_trigger: Optional[str] = None
    use_full_names: bool = False
    subsample_k: int = 0
    subsample_n: int = 0
    chores_filename: Optional[str] = None
    file_type: Optional[str] = None


def parse_sequence_spec(name: str) -> SequenceSpec:
    """Parse `nickname::file/contig[actions]` (reference sequences.c:8027+)."""
    spec = SequenceSpec(filename=name)
    rest = name

    if "::" in rest:
        nick, rest = rest.split("::", 1)
        spec.nickname = nick

    # trailing '-' means reverse complement (file- form)
    actions_txt = None
    if rest.endswith("]-"):
        spec.revcomp = True
        rest = rest[:-1]
    if rest.endswith("]") and "[" in rest:
        i = rest.index("[")
        actions_txt = rest[i + 1 : -1]
        rest = rest[:i]
    elif rest.endswith("-") and not os.path.exists(rest):
        spec.revcomp = True
        rest = rest[:-1]

    # file/contig for 2bit/hsx
    if "/" in rest and not os.path.exists(rest):
        head, tail = rest.rsplit("/", 1)
        if os.path.exists(head):
            spec.filename = head
            spec.contig_of_interest = tail
            rest = head
        else:
            spec.filename = rest
    else:
        spec.filename = rest

    if actions_txt is not None:
        # '<start>,<end>' uses a comma INSIDE one action, so try the
        # whole bracket text as a subrange before comma-splitting
        whole = _parse_subrange(actions_txt)
        if whole is not None:
            spec.start, spec.end = whole
            actions_txt = ""
        for action in actions_txt.split(","):
            action = action.strip()
            if not action:
                continue
            low = action.lower()
            sub = _parse_subrange(action)
            if sub is not None:
                spec.start, spec.end = sub
                continue
            if low == "multiple" or low == "multi":
                spec.do_partition = True
            elif low == "unmask":
                spec.unmask = True
            elif low in ("revcomp", "rc"):
                spec.revcomp = True
            elif low == "backward":
                spec.backward = True
            elif low.startswith("subset="):
                spec.names_filename = action[7:]
            elif low.startswith("@"):
                spec.names_filename = action[1:]
                spec.do_partition = True
            elif low.startswith("nmask="):
                spec.nmask_filename = action[6:]
            elif low.startswith("xmask="):
                spec.xmask_filename = action[6:]
            elif low.startswith("softmask="):
                spec.softmask_filename = action[9:]
            elif low.startswith("separator="):
                spec.separator = action[10:]
                spec.do_partition = True
            elif low.startswith("nickname=") or low.startswith("name="):
                spec.nickname = action.split("=", 1)[1]
            elif low.startswith("nameparse="):
                val = action.split("=", 1)[1]
                if val == "darkspace":
                    spec.name_parse_type = NAME_PARSE_DARKSPACE
                elif val == "alphanum":
                    spec.name_parse_type = NAME_PARSE_ALNUM
                elif val == "full":
                    spec.use_full_names = True
                elif val.startswith("tag:"):
                    spec.name_trigger = val[4:]
            elif low.startswith("chores="):
                spec.chores_filename = action.split("=", 1)[1]
            elif low.startswith("subsample="):
                # k must be >= 1 and n >= k (sequences.c:8309-8333)
                sval = action.split("=", 1)[1]
                try:
                    k_s, n_s = sval.split("/")
                    k, n = int(k_s), int(n_s)
                except ValueError:
                    k, n = 0, -1
                if k < 1 or n < k:
                    raise SystemExit(
                        'FAILURE: (for %s) bad subsample "%s"'
                        % (spec.filename, sval))
                spec.subsample_k, spec.subsample_n = k, n
            elif low in ("fasta", "fastq", "nib", "2bit", "hsx", "csfasta", "qdna"):
                spec.file_type = low
            elif low == "quantum":
                spec.file_type = "qdna"
            else:
                # range like "51..200" handled above; unknown action
                raise ValueError(f"unknown sequence action: {action}")
    return spec


def sniff_file_type(path: str) -> str:
    """Identify the file format by magic number (reference
    sequences.c:9060-9110)."""
    import struct

    with open(path, "rb") as f:
        magic = f.read(4)
    if len(magic) == 4:
        big = struct.unpack(">I", magic)[0]
        if big in (0x6BE93D3A, 0x3A3DE96B):
            return "nib"
        if big in (0x1A412743, 0x4327411A):
            return "2bit"
        if big in (0xD2527095, 0x957052D2):
            return "hsx"
        if big in (0xC4B47197, 0x9771B4C4, 0x9E6556F6, 0xF656659E):  # qdna
            return "qdna"
    if magic[:1] == b"@":
        return "fastq"
    if path.endswith(".csfasta"):
        return "csfasta"
    return "fasta"


class SequenceFile:
    """Iterates records of a sequence file (reference open_sequence_file)."""

    def __init__(self, name: str, default_type: str = "fasta",
                 chores_filename: str | None = None):
        if name is None or name == "-":
            # query from stdin (reference: "(stdin)")
            import sys
            self._stdin_data = sys.stdin.buffer.read()
            self.spec = SequenceSpec(filename="(stdin)")
            self.filename = "(stdin)"
            self.file_type = ("fastq" if self._stdin_data[:1] == b"@"
                              else "fasta")
            self.contig_index = 0
            self._records = None
            self._cursor = 0
            self._subset_names = None
            self._chores = None
            self._chore_ix = 0
            self._chore_num = 0
            self._chore_rec = None
            return
        self._stdin_data = None
        self.spec = parse_sequence_spec(name)
        self.filename = self.spec.filename
        self.file_type = self.spec.file_type or sniff_file_type(self.filename)
        self.contig_index = 0
        self._records = None  # lazily parsed list
        self._cursor = 0
        self._subset_names = None
        self._chores = None
        self._chore_ix = 0
        self._chore_num = 0
        self._chore_rec = None
        chf = chores_filename or self.spec.chores_filename
        if chf:
            self._chores = parse_chores_file(chf)
        if self.spec.names_filename and not self.spec.do_partition:
            with open(self.spec.names_filename) as f:
                self._subset_names = [ln.strip() for ln in f if ln.strip()]

    # --- record parsing -------------------------------------------------

    def _load_records(self):
        if self._records is not None:
            return
        if self._stdin_data is not None:
            if self.file_type == "fastq":
                self._records = _parse_fastq_bytes(self._stdin_data)
            else:
                self._records = _parse_fasta_bytes(self._stdin_data)
            return
        if self.file_type == "fasta":
            self._records = _read_fasta(self.filename)
        elif self.file_type == "fastq":
            self._records = _read_fastq(self.filename)
        elif self.file_type == "nib":
            self._records = [_read_nib(self.filename)]
        elif self.file_type == "2bit":
            self._records = _read_2bit(self.filename)
        elif self.file_type == "hsx":
            self._records = _read_hsx(self.filename)
        elif self.file_type == "qdna":
            self._records = [_read_qdna(self.filename)]
        elif self.file_type == "csfasta":
            # the reference bails out identically (sequences.c csfasta
            # support is a stub behind this message)
            raise SystemExit(
                "FAILURE: sorry, color space is not fully implemented yet")
        else:
            raise NotImplementedError(f"file type {self.file_type}")
        if self.spec.subsample_n > 1:
            # [subsample=k/n] (sequences.c:1075-1081,1884-1918): keep
            # records k, k+n, k+2n, ... (origin-1), both for sequential
            # reads and for [multi] partitioned loads
            k, n = self.spec.subsample_k, self.spec.subsample_n
            self._records = self._records[k - 1::n]
        if self.spec.contig_of_interest:
            want = self.spec.contig_of_interest
            recs = [r for r in self._records if r[2] == want]
            if not recs:
                raise ValueError(
                    f"sequence {want} not found in {self.filename}")
            self._records = recs
        elif self._subset_names is not None:
            by_name = {r[2]: r for r in self._records}
            missing = [n for n in self._subset_names if n not in by_name]
            if missing:
                raise ValueError(
                    f"sequences not found in {self.filename}: {missing}")
            self._records = [by_name[n] for n in self._subset_names]
        else:
            return
        if self.file_type == "hsx":
            # hsx name lookups never touch the contig counter, so the
            # reference reports contig 0 for them (load_hsx_sequence)
            self._records = [(r[0], r[1], r[2], 0) + tuple(r[4:])
                             for r in self._records]

    def rewind(self):
        self._cursor = 0
        self.contig_index = 0
        self._chore_ix = 0
        self._chore_num = 0
        self._chore_rec = None

    def load(self) -> Optional[Sequence]:
        """Load next record (reference load_sequence); None at EOF.
        With a chores file, one record is returned PER CHORE (the
        underlying sequence advances when the chore names a new
        query; names must appear in file order)."""
        self._load_records()
        if self._chores is not None:
            return self._load_chore()
        if self.spec.do_partition:
            return self._load_partitioned()
        while self._cursor < len(self._records):
            rec = self._records[self._cursor]
            self._cursor += 1
            seq = self._materialize(*rec)
            return seq
        return None

    def _load_chore(self) -> Optional[Sequence]:
        import dataclasses
        if self._chore_ix >= len(self._chores):
            return None
        ch = self._chores[self._chore_ix]
        self._chore_ix += 1
        if self._chore_rec is not None and self._chore_rec[2] == ch.q_name:
            self._chore_num += 1
        else:
            # advance (in order) to the record the chore names
            rec = None
            while self._cursor < len(self._records):
                cand = self._records[self._cursor]
                self._cursor += 1
                if cand[2] == ch.q_name:
                    rec = cand
                    break
            if rec is None:
                raise SystemExit(
                    f"FAILURE: chores file query name {ch.q_name} does"
                    f" not exist in {self.filename}\n(or chore queries"
                    f" are out of order)")
            self._chore_rec = rec
            self._chore_num = 1
        seq = self._materialize(*self._chore_rec)
        seq.chore = dataclasses.replace(ch, num=self._chore_num)
        return seq

    def _materialize(self, data, header, short, contig, quals=None) -> Sequence:
        true_len = len(data)
        qdata = quals
        start_loc = 1
        if self.spec.start or self.spec.end:
            s = self.spec.start or 1
            e = self.spec.end or true_len
            if e > true_len:
                if self.spec.end_is_soft or self.spec.end == 0:
                    e = true_len
                else:
                    raise ValueError(
                        f"subrange end {e} exceeds sequence length {true_len}")
            if s < 1 or s > e:
                raise ValueError(f"bad subrange {s}..{e}")
            data = data[s - 1 : e]
            if qdata:
                qdata = qdata[s - 1 : e]
            start_loc = s
        v = np.frombuffer(data, dtype=np.uint8).copy()
        if self.spec.unmask:
            lower = (v >= ord("a")) & (v <= ord("z"))
            v[lower] -= 32
        if self.spec.nickname:
            header = self.spec.nickname
            short = self.spec.nickname
        seq = Sequence(
            v=v,
            filename=self.filename,
            header=header,
            short_header=short,
            start_loc=start_loc,
            true_len=true_len,
            contig=contig,
            file_type=self.file_type,
            use_full_names=self.spec.use_full_names,
            vq=(np.frombuffer(qdata, dtype=np.uint8).copy()
                if qdata else None),
        )
        for maskfile, ch in ((self.spec.nmask_filename, ord("N")),
                             (self.spec.xmask_filename, ord("X"))):
            if maskfile:
                _apply_mask_file(seq, maskfile, ch)
        if self.spec.softmask_filename:
            _apply_mask_file(seq, self.spec.softmask_filename, 0)
        if self.spec.revcomp:
            seq.rev_comp()
            seq.rev_comp_flags = RCF_REVCOMP
        if self.spec.backward:
            seq.v = seq.v[::-1].copy()
            seq.rev_comp_flags = RCF_REV
        return seq

    def _load_partitioned(self) -> Optional[Sequence]:
        """Concatenate all records with NUL separators ([multi])."""
        if self._cursor > 0:
            return None
        self._cursor = len(self._records)
        names = None
        if self.spec.names_filename:
            with open(self.spec.names_filename) as f:
                names = [ln.strip() for ln in f if ln.strip()]
        recs = self._records
        if names is not None:
            by_name = {r[2]: r for r in recs}
            recs = [by_name[n] for n in names if n in by_name]
        chunks = [b"\0"]
        parts = []
        pos = 1
        for rec in recs:
            data, header, short, contig = rec[:4]
            true_len = len(data)
            start_loc = 1
            if self.spec.start or self.spec.end:
                s = self.spec.start or 1
                e = self.spec.end or true_len
                e = min(e, true_len)
                if s > true_len:
                    continue
                data = data[s - 1 : e]
                start_loc = s
            # the reference's partition pool stores parsed names, not
            # the raw '>' header lines (sequences.c separate_sequence)
            disp_name = (header.lstrip(">").strip()
                         if self.spec.use_full_names else short)
            parts.append(Partition(
                sep_before=pos - 1,
                sep_after=pos + len(data),
                header=disp_name,
                true_len=true_len,
                start_loc=start_loc,
                contig=contig,
            ))
            chunks.append(data)
            chunks.append(b"\0")
            pos += len(data) + 1
        buf = b"".join(chunks)
        v = np.frombuffer(buf, dtype=np.uint8).copy()
        seq = Sequence(
            v=v,
            filename=self.filename,
            header="",
            short_header="",
            true_len=len(v),
            file_type=self.file_type,
            partitions=parts,
            separator=self.spec.separator,
        )
        return seq


def open_sequence_file(name: str) -> SequenceFile:
    return SequenceFile(name)


# --- format readers -----------------------------------------------------


def _read_fasta(path: str):
    """Return list of (data_bytes, header, short_header, contig)."""
    with open(path, "rb") as f:
        data = f.read()
    return _parse_fasta_bytes(data)


def _parse_fasta_bytes(data: bytes):
    # vectorized fast path for files without carriage returns (the
    # common case; a 90 Mbp chromosome parses in ~0.3s instead of ~3s
    # of per-line Python) — the line loop below is the exact-behavior
    # fallback for \r-bearing files
    if b"\r" not in data:
        return _parse_fasta_fast(data)
    return _parse_fasta_lines(data)


def _parse_fasta_lines(data: bytes):
    records = []
    header = None
    chunks: list[bytes] = []
    contig = 0
    lines = data.split(b"\n")
    for raw in lines:
        line = raw.rstrip(b"\r")
        if line.startswith(b">"):
            if header is not None:
                contig += 1
                records.append(_fasta_record(chunks, header, contig))
            header = line.decode("latin-1")
            chunks = []
        elif line:
            chunks.append(line.replace(b" ", b"").replace(b"\t", b""))
    if header is not None:
        contig += 1
        records.append(_fasta_record(chunks, header, contig))
    elif chunks:
        contig += 1
        records.append(_fasta_record(chunks, "", contig))
    return records


def _parse_fasta_fast(data: bytes):
    """Vectorized _parse_fasta_bytes for \\r-free data: same records
    (headers kept verbatim; newlines/spaces/tabs stripped from
    bodies; content before the first '>' discarded like the line
    loop's)."""
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    if n == 0:
        return []
    gts = np.flatnonzero(arr == ord(">"))
    if len(gts):
        at_line_start = np.where(
            gts == 0, True, arr[np.maximum(gts, 1) - 1] == 10)
        heads = gts[at_line_start]
    else:
        heads = gts
    keep = ~((arr == 10) | (arr == 32) | (arr == 9))
    records = []
    if len(heads) == 0:
        body = arr[keep].tobytes()
        if body:
            records.append(_fasta_record([body], "", 1))
        return records
    bounds = np.append(heads, n)
    for i in range(len(heads)):
        a, b = int(bounds[i]), int(bounds[i + 1])
        hend = data.find(b"\n", a, b)
        if hend < 0:
            hend = b
        header = data[a:hend].decode("latin-1")
        seg = arr[hend + 1: b]
        body = seg[keep[hend + 1: b]].tobytes()
        records.append(_fasta_record([body], header, i + 1))
    return records


def _fasta_record(chunks, header, contig):
    data = b"".join(chunks)
    short = shorten_header(header) if header else ""
    return (data, header, short, contig)


def _read_hsx(path: str):
    """Read sequences via an .hsx index (reference load_hsx_sequence,
    sequences.c; format spec in tools/hsx_file.py:7-77).  Sequences
    come back in index (hash) order, exactly as the reference
    enumerates them."""
    from ..tools.hsx import read_hsx

    ix = read_hsx(path)
    file_cache: dict = {}
    records = []
    for contig, e in enumerate(ix.entries, start=1):
        ftype = ix.files[e.file_num][0]
        if ftype not in ("fa", "fasta"):
            raise SystemExit(
                f"FAILURE: hsx referencing {ftype} files is not supported")
        fpath = ix.resolve_file(e.file_num)
        if fpath not in file_cache:
            with open(fpath, "rb") as f:
                file_cache[fpath] = f.read()
        data = file_cache[fpath]
        pos = e.offset
        if data[pos : pos + 1] == b">":
            # offset points at the fasta header; skip it -- the name
            # COMES FROM THE INDEX (reference load_hsx_sequence uses the
            # index name, so the '>' never appears in output headers)
            pos = data.find(b"\n", pos) + 1
        header = e.name
        chunks = []
        got = 0
        p = pos
        while got < e.length and p < len(data):
            nl = data.find(b"\n", p)
            if nl < 0:
                nl = len(data)
            line = data[p:nl].rstrip(b"\r")
            if line.startswith(b">"):
                break
            line = line.replace(b" ", b"").replace(b"\t", b"")
            chunks.append(line)
            got += len(line)
            p = nl + 1
        seq = b"".join(chunks)[: e.length]
        if len(seq) != e.length:
            raise SystemExit(
                f'FAILURE: hsx index "{path}" length mismatch for'
                f" {e.name} (expected {e.length}, got {len(seq)})")
        short = shorten_header(header) if header else e.name
        records.append((seq, header, short, contig))
    return records


def _read_qdna(path: str):
    """Read a quantum-DNA file (reference load_qdna_sequence,
    sequences.c:4630-4693): binary header + one byte per quantum
    symbol.  Old-format (magic 9E6556F6) files are a bare symbol
    stream."""
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    magic = struct.unpack(">I", raw[0:4])[0]
    if magic == 0xC4B47197:
        endian = ">"
    elif magic == 0x9771B4C4:
        endian = "<"
    elif magic in (0x9E6556F6, 0xF656659E):
        # version 0: data begins right after the magic
        data = raw[4:]
        header = f"{path}"
        return (data, header, shorten_header(path, skip_path=True), 1)
    else:
        # reference: any binary file is accepted as a bare symbol stream
        data = raw
        return (data, path, shorten_header(path, skip_path=True), 1)
    version = struct.unpack(endian + "I", raw[4:8])[0]
    if (version >> 8) not in (1, 2):
        raise SystemExit(
            f"FAILURE: unsupported qdna version in {path} ({version:08X})")
    seq_offset = struct.unpack(endian + "I", raw[12:16])[0]
    length = struct.unpack(endian + "I", raw[20:24])[0]
    if (version >> 8) == 2:
        prop_offset = struct.unpack(endian + "I", raw[24:28])[0]
        if prop_offset != 0:
            raise SystemExit(
                f"FAILURE: qdna named properties are not supported in {path}")
    data = raw[seq_offset : seq_offset + length]
    header = f"{path}:1-{length}"
    return (data, header, shorten_header(path, skip_path=True), 1)


def _read_fastq(path: str):
    with open(path, "rb") as f:
        data = f.read()
    return _parse_fastq_bytes(data)


def _parse_fastq_bytes(data: bytes):
    records = []
    lines = data.split(b"\n")
    i = 0
    contig = 0
    while i + 3 < len(lines) or (i < len(lines) and lines[i].strip()):
        if not lines[i].strip():
            i += 1
            continue
        if not lines[i].startswith(b"@"):
            raise ValueError(f"bad fastq record at line {i+1}")
        # the '@' is NOT part of the name (reference fastq loader;
        # lav h-stanzas show fastq headers without it)
        header = lines[i][1:].decode("latin-1")
        data = lines[i + 1].strip()
        quals = lines[i + 3].strip() if i + 3 < len(lines) else b""
        contig += 1
        short = shorten_header(">" + header)
        records.append((bytes(data), header, short, contig, bytes(quals)))
        i += 4
    return records


def _read_nib(path: str):
    """Read .nib (4-bit) format (reference load_nib_sequence,
    sequences.c:3399-3580): magic, length, then 2 bases per byte with
    codes 0..7 = T C A G N X X X, +8 for soft-masked (lower case)."""
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    big = struct.unpack(">I", raw[0:4])[0]
    if big == 0x3A3DE96B:  # nibMagicLittle read big-endian
        endian = "<"
    elif big == 0x6BE93D3A:
        endian = ">"
    else:
        raise ValueError(f"bad nib magic number in {path}")
    length = struct.unpack(endian + "I", raw[4:8])[0]
    codes = np.frombuffer(raw[8 : 8 + (length + 1) // 2], dtype=np.uint8)
    interleaved = np.empty(2 * len(codes), dtype=np.uint8)
    interleaved[0::2] = codes >> 4
    interleaved[1::2] = codes & 0xF
    interleaved = interleaved[:length]
    table = np.frombuffer(b"TCAGNXXXtcagnxxx", dtype=np.uint8)
    data = table[interleaved].tobytes()
    header = f"{path}:1-{length}"
    short = shorten_header(path, skip_path=True)
    return (data, header, short, 1)


def _read_2bit(path: str):
    """Read UCSC .2bit files (reference sequences.c twobit support)."""
    import struct

    with open(path, "rb") as f:
        raw = f.read()
    magic_le = struct.unpack("<I", raw[0:4])[0]
    if magic_le == 0x1A412743:
        endian = "<"
    elif struct.unpack(">I", raw[0:4])[0] == 0x1A412743:
        endian = ">"
    else:
        raise ValueError(f"{path} is not a 2bit file")
    seq_count = struct.unpack(endian + "I", raw[8:12])[0]
    off = 16
    entries = []
    for _ in range(seq_count):
        name_size = raw[off]
        name = raw[off + 1 : off + 1 + name_size].decode("latin-1")
        off += 1 + name_size
        offset = struct.unpack(endian + "I", raw[off : off + 4])[0]
        off += 4
        entries.append((name, offset))
    bits_to_char = np.frombuffer(b"TCAG", dtype=np.uint8)
    records = []
    for contig, (name, offset) in enumerate(entries, start=1):
        dna_size = struct.unpack(endian + "I", raw[offset : offset + 4])[0]
        p = offset + 4
        n_count = struct.unpack(endian + "I", raw[p : p + 4])[0]
        p += 4
        n_starts = np.frombuffer(raw[p : p + 4 * n_count], dtype=endian + "u4")
        p += 4 * n_count
        n_sizes = np.frombuffer(raw[p : p + 4 * n_count], dtype=endian + "u4")
        p += 4 * n_count
        m_count = struct.unpack(endian + "I", raw[p : p + 4])[0]
        p += 4
        m_starts = np.frombuffer(raw[p : p + 4 * m_count], dtype=endian + "u4")
        p += 4 * m_count
        m_sizes = np.frombuffer(raw[p : p + 4 * m_count], dtype=endian + "u4")
        p += 4 * m_count
        p += 4  # reserved
        packed = np.frombuffer(
            raw[p : p + (dna_size + 3) // 4], dtype=np.uint8)
        codes = np.empty(len(packed) * 4, dtype=np.uint8)
        codes[0::4] = (packed >> 6) & 3
        codes[1::4] = (packed >> 4) & 3
        codes[2::4] = (packed >> 2) & 3
        codes[3::4] = packed & 3
        v = bits_to_char[codes[:dna_size]].copy()
        for s, ln in zip(n_starts, n_sizes):
            v[s : s + ln] = ord("N")
        for s, ln in zip(m_starts, m_sizes):
            seg = v[s : s + ln]
            upper = (seg >= ord("A")) & (seg <= ord("Z"))
            seg[upper] += 32
        header = name
        short = shorten_header(name)
        records.append((v.tobytes(), header, short, contig))
    return records


def _apply_mask_file(seq: Sequence, path: str, mask_char: int):
    """Apply interval mask file: lines '<start> <end>' origin-1 closed.

    mask_char == 0 means soft-mask (lower-case) instead of replacing.
    """
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.replace(",", " ").split()
            s, e = int(parts[0]), int(parts[1])
            lo = max(0, s - 1 - (seq.start_loc - 1))
            hi = min(len(seq.v), e - (seq.start_loc - 1))
            if lo >= hi:
                continue
            if mask_char == 0:
                seg = seq.v[lo:hi]
                upper = (seg >= ord("A")) & (seg <= ord("Z"))
                seg[upper] += 32
            else:
                seq.v[lo:hi] = mask_char
