"""Readings that set the check's limits, on the card at a cell's size.

    python3 portbench/control.py --workload NAME --seeds 1,2,... \
        --fault-seeds 3 [--faults A,B] --seconds 20 --out FILE

For each seed, one set-up and one short window at the cell's own load,
then the check of its outputs as the program gave them (the lower
reading of every number) and, for the first `--fault-seeds` seeds, of
the same outputs under the control and each planted fault that faults.py
keys to the configuration's judge (the upper readings; `--faults` names
a few of them). The numbers are that judge's `NUMBERS`. One JSON line a
reading goes to FILE; the summary, each number's highest sound reading
and lowest reading under each fault, to standard output.
"""

import argparse
import copy
import json
import os
import sys
import tempfile
import time

PROCESS_START = time.monotonic()


def main(argv):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench import guard
    from portbench.bench import Cell
    from portbench.cellrun import check, measure
    from portbench.faults import FAULTS
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--faults", default=None)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device\n")
        return 3
    cell = Cell(args.workload)
    names = cell.judge().NUMBERS
    faults = FAULTS[cell.check_name]
    device = torch.device("cuda", 0)
    sound = {k: [] for k in names}
    broken = {}
    with open(args.out, "a") as out:
        for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
            try:
                with tempfile.TemporaryDirectory(
                        dir=os.environ.get("TMPDIR") or None) as tmp:
                    run, _ = measure(cell, seed, args.seconds, False,
                                     device, time.monotonic(), tmp)
            except guard.Unmeasurable as failure:
                # a configuration whose runs never drive the card gets
                # no limits
                return guard.ended(failure, sys.stderr)
            chosen = (args.faults.split(",") if args.faults
                      else list(faults))
            variants = [None] + (chosen if n < args.fault_seeds else [])
            for fault in variants:
                recs = copy.deepcopy(run.records)
                numbers, facts = check(cell, run, recs, fault)
                line = {"workload": cell.name, "seed": seed,
                        "variant": fault or "sound", "numbers": numbers,
                        "facts": facts}
                out.write(json.dumps(line) + "\n")
                out.flush()
                for k in names:
                    if fault is None:
                        sound[k].append(numbers[k])
                    else:
                        broken.setdefault(fault, {}).setdefault(
                            k, []).append(numbers[k])
    summary = {"workload": cell.name,
               "lower": {k: max(v) for k, v in sound.items()},
               "sound_seeds": len(sound[names[0]]),
               "upper_by_variant": {f: {k: min(v) for k, v in d.items()}
                                    for f, d in broken.items()}}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
