"""Command-line entry of the port, option-compatible with LASTZ:

    python -m lastz_tpu_torch.cli target [query] [options]

Mirrors lastz_tpu/cli.py:1291-1345 with the port's Pipeline; the
options are parsed by lastz_tpu.cli.parse_options and the output
carries lastz_tpu's program name, so both packages write the same
bytes.  LASTZ_TORCH_DEVICE picks `cuda` (the default) or `cpu`.
"""

from __future__ import annotations

import sys

from lastz_tpu.cli import UsageError, parse_options


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    try:
        cfg = parse_options(argv)
    except UsageError as e:
        print(f"lastz_tpu: {e}", file=sys.stderr)
        return 1
    if cfg.seq1_filename is None and not cfg.read_capsule:
        print("usage: lastz_tpu target [query] [options]", file=sys.stderr)
        return 1

    out = sys.stdout
    close = False
    if getattr(cfg, "output_filename", None):
        out = open(cfg.output_filename, "w")
        close = True
    try:
        try:
            return _run(cfg, out)
        except ValueError as e:
            # user-facing input errors exit like the reference's suicide()
            print(f"FAILURE: {e}", file=sys.stderr)
            return 1
        except OSError as e:
            # reference fopen_or_die (utilities.c)
            name = getattr(e, "filename", None)
            if name is None:
                raise
            print(f'FAILURE: fopen_or_die failed to open "{name}"'
                  f' for "rb"', file=sys.stderr)
            return 1
    finally:
        if close:
            out.close()


def _run(cfg, out):
    from .pipeline import Pipeline

    if cfg.infer_scores:
        from lastz_tpu.infer import drive_scoring_inference
        inferred = drive_scoring_inference(
            cfg, cfg.infer_control_filename, cfg.infer_scores_filename)
        if cfg.infer_only:
            return 0
        cfg.scoring = inferred
        cfg.masked_scoring = None
    Pipeline(cfg, out).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
