"""The gapped-extension accept loop with the port's device stage.

A copy of lastz_tpu/align/ydrop.py::gapped_extend (:1492-1748,
reference gapped_extend.c:1012) that builds the torch DeviceYDrop
(align/ydrop_device.py) instead of the JAX one.  Everything else is
imported from lastz_tpu.align.ydrop unchanged.  Per-anchor routing to
the host engine stays (bounded anchors, overlap with an accepted box,
window overflow, traceback redo) and is counted in --stats; a device
failure is an error, not a silent switch to the host.
"""

from __future__ import annotations

from lastz_tpu import stats as _stats
from lastz_tpu.align.edit_script import Alignment, EditScript
from lastz_tpu.align.segments import SegmentTable
from lastz_tpu.align.ydrop import (AcceptIndex, GAlign, YDropAligner,
                                   _identity_score, align_left_right,
                                   count_paired_bases, format_alignment,
                                   identical_partition_of_sequence,
                                   identical_partitioned_sequences,
                                   identical_sequences, msp_left_right)

from .ydrop_device import DeviceYDrop


def gapped_extend(target, query, scoring, anchors: SegmentTable,
                  inhibit_trivial=False, y_drop=9400, trim_to_peak=True,
                  score_thresh=None, traceback_mem=80 * 1024 * 1024,
                  all_bounds=False, max_paired_bases=0,
                  overly_paired_warn=False, overly_paired_keep=False,
                  on_overly_paired=None, device=None,
                  truncation_report=True):
    """reference gapped_extend (gapped_extend.c:1012), unpartitioned path.

    Returns list of Alignment in increasing-start order.  With a torch
    `device`, extensions run batched through K1 and only anchors whose
    DP could interact with previously accepted alignments run on the
    host engine (see align/ydrop_device.py); device=None runs every
    anchor on the host.
    """
    thresh = score_thresh.s if score_thresh is not None else 0

    aligner = YDropAligner(target.v, query.v, scoring, y_drop, trim_to_peak,
                           traceback_mem,
                           truncation_report=truncation_report)

    # sort anchors by decreasing score (reference batched_segments ->
    # qSegmentsByDecreasingScore; ties prefer shorter, then pos2, pos1, id)
    segs = sorted(
        anchors.segments,
        key=lambda g: (-g.score, g.length, g.pos2, g.pos1, g.seg_id))

    msps = []
    for k, seg in enumerate(segs):
        g = GAlign(pos1=seg.pos1, pos2=seg.pos2,
                   end1=seg.pos1 + seg.length - 1,
                   end2=seg.pos2 + seg.length - 1,
                   hsp_id=seg.hsp_id if seg.hsp_id else k + 1)
        msps.append(g)

    dev_ydrop = None
    if device is not None and segs:
        seg_infos = []
        for seg in segs:
            low1, high1 = 0, len(target.v)
            low2, high2 = 0, len(query.v)
            if target.is_partitioned:
                p1 = target.lookup_partition(seg.pos1)
                low1, high1 = p1.sep_before + 1, p1.sep_after
            if query.is_partitioned:
                p2 = query.lookup_partition(seg.pos2)
                low2, high2 = p2.sep_before + 1, p2.sep_after
            seg_infos.append((seg.pos1, seg.pos2, low1, high1,
                              low2, high2))
        dev_ydrop = DeviceYDrop(target.v, query.v, scoring, y_drop,
                                trim_to_peak, traceback_mem, seg_infos,
                                device)
        if not dev_ydrop.ok:
            dev_ydrop = None
    # incremental index over accepted alignments: obi/oed linked lists,
    # stab/overlap bins, and the device-safety bounding boxes
    aidx = AcceptIndex()
    n_bbox = 0

    if dev_ydrop is not None:
        # lazy-batch heuristic: don't speculatively extend anchors
        # whose point already lies inside an accepted alignment's box
        dev_ydrop.precheck = (
            lambda j: not aidx.in_bbox(dev_ydrop.seg_infos[j][0],
                                       dev_ydrop.seg_infos[j][1]))

    obi = oed = None
    paired_bases = 0

    # trivial self-alignment
    is_ident, ident_score = identical_sequences(target, query, scoring)
    if is_ident:
        mp = GAlign(pos1=0, pos2=0,
                    end1=len(target.v) - 1, end2=len(target.v) - 1)
        mp.save_seg(mp.pos1, mp.pos2, mp.end1, mp.end2)
        aidx.insert(mp)
        obi, oed = aidx.obi, aidx.oed
        mp.last_seg = mp.first_seg
        mp.first_seg.prev_seg = None
        mp.last_seg.next_seg = None
        script = EditScript()
        script.add("S", len(target.v))
        a = Alignment(beg1=1, beg2=1, end1=len(target.v), end2=len(target.v),
                      script=script,
                      score=max(ident_score, thresh), is_trivial=True)
        mp.align = a
        aidx.add_bbox(0, len(target.v) - 1, 0, len(target.v) - 1)
        n_bbox += 1
    else:
        # partitioned triviality (gapped_extend.c:1123-1280)
        triv_pairs = []
        if target.is_partitioned and not query.is_partitioned:
            ix = identical_partition_of_sequence(target, query)
            if ix >= 0:
                p1 = target.partitions[ix]
                triv_pairs = [(p1.sep_before + 1, p1.sep_after - 1,
                               0, len(query.v) - 1)]
        elif target.is_partitioned and query.is_partitioned \
                and identical_partitioned_sequences(target, query):
            triv_pairs = [
                (p1.sep_before + 1, p1.sep_after - 1,
                 p2.sep_before + 1, p2.sep_after - 1)
                for p1, p2 in zip(target.partitions, query.partitions)]
        for (b1, e1, b2, e2) in triv_pairs:
            mp = GAlign(pos1=b1, pos2=b2, end1=e1, end2=e2)
            mp.save_seg(b1, b2, e1, e2)
            aidx.insert(mp)
            obi, oed = aidx.obi, aidx.oed
            mp.last_seg = mp.first_seg
            mp.first_seg.prev_seg = None
            mp.last_seg.next_seg = None
            s = _identity_score(scoring, target.v[b1:e1 + 1],
                                query.v[b2:e2 + 1])
            script = EditScript()
            script.add("S", e1 - b1 + 1)
            a = Alignment(beg1=b1 + 1, beg2=b2 + 1,
                          end1=e1 + 1, end2=e2 + 1, script=script,
                          score=max(s, thresh), is_trivial=True)
            mp.align = a
            aidx.add_bbox(b1, e1, b2, e2)
            n_bbox += 1

    _x = _stats.current.extra
    for k, mp in enumerate(msps):
        if not msp_left_right(obi, mp, cands=aidx.stab(mp.pos1)):
            if dev_ydrop is not None:
                dev_ydrop.release(k)
            continue
        aligner.left_align = mp.left_align1
        aligner.right_align = mp.right_align1
        aligner.left_seg = mp.left_seg1
        aligner.right_seg = mp.right_seg1
        aligner.above_list, aligner.below_list = \
            aidx.above_below(mp.pos1)

        # partitioned sequences: clamp the DP to the anchor's partition
        # (gapped_extend.c:1355-1375)
        if target.is_partitioned:
            p1 = target.lookup_partition(mp.pos1)
            aligner.low1, aligner.high1 = p1.sep_before + 1, p1.sep_after
        if query.is_partitioned:
            p2 = query.lookup_partition(mp.pos2)
            aligner.low2, aligner.high2 = p2.sep_before + 1, p2.sep_after

        use_dev = dev_ydrop is not None
        if use_dev and not (mp.left_seg1 is None
                            and mp.right_seg1 is None):
            use_dev = False
            _x["dev-skip bounded"] = _x.get("dev-skip bounded", 0) + 1
        if use_dev and aidx.in_bbox(mp.pos1, mp.pos2):
            use_dev = False
            _x["dev-skip in-bbox"] = _x.get("dev-skip in-bbox", 0) + 1
        if use_dev:
            dev_ydrop.result_for(k)
            use_dev = dev_ydrop.statuses_ok(k)
            if not use_dev:
                _x["dev-skip status"] = _x.get("dev-skip status", 0) + 1
        if use_dev and n_bbox:
            r1lo, r1hi, r2lo, r2hi = dev_ydrop.explored_rect(k)
            if aidx.any_bbox_overlap(r1lo, r1hi, r2lo, r2hi):
                use_dev = False
                _x["dev-skip overlap"] = \
                    _x.get("dev-skip overlap", 0) + 1
        if use_dev:
            dev_ydrop.stats_device += 1
            s, start1, start2, stop1, stop2, script = dev_ydrop.compose(
                aligner, k, mp.pos1, mp.pos2)
        else:
            if dev_ydrop is not None:
                dev_ydrop.stats_host += 1
            with _stats.current.time("ydrop host"):
                s, start1, start2, stop1, stop2, script = \
                    aligner.ydrop_align(mp.pos1, mp.pos2)
        if dev_ydrop is not None:
            dev_ydrop.release(k)
        mp.align = None
        a = format_alignment(target.v, query.v, start1, start2, stop1, stop2,
                             s, script, mp)
        mp.align = a
        mp.pos1, mp.pos2 = start1, start2
        mp.end1, mp.end2 = stop1, stop2

        if mp.first_seg is None:
            continue
        mp.last_seg = mp.first_seg.prev_seg
        mp.first_seg.prev_seg = None
        mp.last_seg.next_seg = None

        if (not all_bounds) and a.score < thresh:
            mp.first_seg = mp.last_seg = None
            continue

        align_left_right(obi, mp,
                         cands=aidx.overlapping(mp.pos1, mp.end1))
        aidx.insert(mp)
        obi, oed = aidx.obi, aidx.oed
        aidx.add_bbox(mp.pos1, mp.end1, mp.pos2, mp.end2)
        n_bbox += 1

        # paired-bases limit (gapped_extend.c:1444-1459): stop processing
        # HSPs; without 'keep', discard everything for this query/strand
        if max_paired_bases > 0:
            paired_bases += count_paired_bases(mp)
            if paired_bases > max_paired_bases:
                if overly_paired_warn and on_overly_paired is not None:
                    on_overly_paired()
                if not overly_paired_keep:
                    return []
                break

    _stats.current.gapped_anchors += len(msps)
    if dev_ydrop is not None:
        _stats.current.gapped_device += dev_ydrop.stats_device
        _stats.current.gapped_host += dev_ydrop.stats_host
    else:
        _stats.current.gapped_host += len(msps)

    # collect qualifying alignments in obi order
    out = []
    mp = obi
    while mp is not None:
        a = mp.align
        keep = a is not None and a.score >= thresh
        if keep and inhibit_trivial and a.is_trivial:
            keep = False
        if keep:
            out.append(a)
        mp = mp.next
    _stats.current.alignments += len(out)
    return out
