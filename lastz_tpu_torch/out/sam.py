"""SAM output format (reference sam.c): soft/hard-clipped reads."""

from __future__ import annotations

from .cigar import _mismatchy_run

BAM_FREVERSE = 0x10


def sam_job_header(cfg, read_group=None) -> str:
    out = ["@HD\tVN:1.0\tSO:unsorted\n"]
    if read_group:
        out.append(f"@RG\t{read_group}\n")
    return "".join(out)


def sam_sq_header(seq1) -> str:
    """@SQ lines; one per target partition (reference print_sam_header)."""
    out = []
    if seq1.is_partitioned:
        for part in seq1.partitions:
            out.append(f"@SQ\tSN:{part.header}\tLN:{part.true_len}\n")
    else:
        name1 = seq1.name_for_output() or "seq1"
        out.append(f"@SQ\tSN:{name1}\tLN:{seq1.true_len}\n")
    return "".join(out)


def _upper_text(seg):
    out = seg.copy()
    lower = (out >= ord("a")) & (out <= ord("z"))
    out[lower] -= 32
    return out.tobytes().decode("latin-1")


def _lower_text(seg):
    out = seg.copy()
    upper = (out >= ord("A")) & (out <= ord("Z"))
    out[upper] += 32
    return out.tobytes().decode("latin-1")


def sam_match(cfg, seq1, pos1, seq2, pos2, length, hard=False) -> str:
    """One ungapped HSP as a SAM record (reference print_sam_match,
    sam.c:524-660): identical to the gapped record with a single M run."""
    from ..align.edit_script import EditScript, Alignment

    script = EditScript()
    script.add("S", length)
    a = Alignment(beg1=pos1 + 1, beg2=pos2 + 1,
                  end1=pos1 + length, end2=pos2 + length,
                  script=script, score=0)
    return sam_align(cfg, seq1, seq2, a, hard=hard)


def sam_align(cfg, seq1, seq2, a, hard=False) -> str:
    """One SAM record (reference print_sam_align)."""
    beg1, beg2 = a.beg1, a.beg2
    height = a.end1 - beg1 + 1
    len2 = a.end2 - beg2 + 1
    soft = not hard
    mark = cfg.sam_mark_mismatches if hasattr(cfg, "sam_mark_mismatches") \
        else False

    if seq1.is_partitioned:
        part = seq1.lookup_partition(beg1 - 1)
        name1 = part.header
        offset1 = part.sep_before + 1
        start_loc1 = part.start_loc
    else:
        name1 = seq1.name_for_output() or "seq1"
        offset1 = 0
        start_loc1 = seq1.start_loc
    if seq2.is_partitioned:
        part = seq2.lookup_partition(beg2 - 1)
        name2 = part.header
        offset2 = part.sep_before + 1
        seq2_len = part.sep_after - offset2
        seq2_true = part.true_len
        start_loc2 = part.start_loc
    else:
        name2 = seq2.name_for_output() or "seq2"
        offset2 = 0
        seq2_len = len(seq2.v)
        seq2_true = seq2.true_len
        start_loc2 = seq2.start_loc

    start1 = beg1 - 1 - offset1 + start_loc1
    if seq2.rev_comp_flags & 2:
        start2 = start_loc2 + offset2 + (seq2_len - beg2) - (len2 - 1)
        end2 = start_loc2 + offset2 + (seq2_len - beg2)
        flag = BAM_FREVERSE
    else:
        start2 = beg2 - 1 - offset2 + start_loc2
        end2 = start2 - 1 + len2
        flag = 0

    out = [f"{name2}\t{flag}\t{name1}\t{start1}\t255\t"]

    mask_ch = "S" if soft else "H"
    pre_mask = start2 - 1 if start2 > 1 else 0
    post_mask = seq2_true - end2 if end2 < seq2_true else 0
    if seq2.rev_comp_flags & 2:
        pre_mask, post_mask = post_mask, pre_mask
    if pre_mask:
        out.append(f"{pre_mask}{mask_ch}")

    i = j = 0
    for op, run in a.script.ops:
        if op == "S":
            if mark:
                out.append(_mismatchy_run(
                    seq1.v, seq2.v, beg1 - 1 + i, beg2 - 1 + j, run,
                    letter_after=True, with_spaces=False,
                    hide_singles=False, lower_case=False))
            else:
                out.append(f"{run}M")
            i += run
            j += run
        elif op == "D":
            out.append(f"{run}D")
            i += run
        else:
            out.append(f"{run}I")
            j += run
    if post_mask:
        out.append(f"{post_mask}{mask_ch}")

    out.append("\t*\t0\t0\t")

    # seq field
    pos2 = beg2 - 1
    start2_rel = pos2 - offset2 + start_loc2
    pieces = []
    if soft and start2_rel > 1:
        flank = seq2.v[pos2 - (start2_rel - 1) : pos2]
        pieces.append(_lower_text(flank))
    pieces.append(_upper_text(seq2.v[pos2 : pos2 + len2]))
    end2_rel = start2_rel - 1 + len2
    if soft and end2_rel < seq2_true:
        tail_len = seq2_true - (start2_rel - 1) - len2
        flank = seq2.v[pos2 + len2 : pos2 + len2 + tail_len]
        pieces.append(_lower_text(flank))
    out.append("".join(pieces))

    # qual field
    if seq2.vq is None:
        out.append("\t*")
    else:
        qpieces = []
        if soft and start2_rel > 1:
            qpieces.append(
                seq2.vq[pos2 - (start2_rel - 1) : pos2]
                .tobytes().decode("latin-1"))
        qpieces.append(
            seq2.vq[pos2 : pos2 + len2].tobytes().decode("latin-1"))
        if soft and end2_rel < seq2_true:
            tail_len = seq2_true - (start2_rel - 1) - len2
            qpieces.append(
                seq2.vq[pos2 + len2 : pos2 + len2 + tail_len]
                .tobytes().decode("latin-1"))
        out.append("\t" + "".join(qpieces))

    rg = getattr(cfg, "sam_rg_tags", None)
    if rg:
        out.append("\t" + rg)
    out.append("\n")
    return "".join(out)
