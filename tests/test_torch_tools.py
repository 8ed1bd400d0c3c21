"""The port's standalone tools (lastz_tpu_torch/tools/, copies of
lastz_tpu/tools/): each tool's `python -m` form, run from both packages
on the inputs of tests/test_tools.py and tests/test_tools_extra.py
that need no reference data, writes byte-equal output and exits with
the same code.  The port's side runs with `jax` and `lastz_tpu`
blocked, so each tool stands alone."""

import os
import struct
import subprocess
import sys

import pytest
import torch_threads  # noqa: F401  (a share of the cores per xdist worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOOLS = ("alignment_table", "any_to_qdna", "axt_compare",
         "chain_alignments", "cigar_utils", "expand_scores_file",
         "fasta_fragments", "fasta_softmask_intervals", "gfa_compare",
         "hassock_hash", "lav_compare", "lav_sort", "maf_sort",
         "merge_masking_intervals", "pick_from_fasta_hsx",
         "probabilities_to_scores", "qcode_to_scores", "tabular_to_maf")

# a tool module run as `python -m` would run it, with jax and lastz_tpu
# unimportable
_BLOCKED = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['lastz_tpu'] = None\n"
    "mod = sys.argv[1]\n"
    "sys.argv = [mod] + sys.argv[2:]\n"
    "runpy.run_module(mod, run_name='__main__', alter_sys=True)\n")

MAF = """##maf version=1
a score=100
s cat  10 5 + 100 ACGTA
s pigB  3 5 + 50  ACCTA

a score=300
s cat   2 5 + 100 GGGTA
s pigA  8 5 + 50  GGCTA

a score=200
s cat   2 5 + 100 TTGTA
s pigB  1 5 + 50  TTCTA
"""

LAV = ("#:lav\n"
       "s {\n  x\n}\n"
       "a {\n  s 5\n  b 9 1\n  e 10 2\n}\n"
       "a {\n  s 7\n  b 3 4\n  e 4 5\n}\n"
       "#:eof\n")

AXT = ("0 cat 101 200 pig 11 110 + 5000\n"
       "ACGT\n"
       "ACGT\n"
       "\n"
       "1 cat 301 400 pig 51 150 - 4000\n"
       "AAAA\n"
       "AAAA\n")

SCORES = (b"gap_open_penalty   = 400\n"
          b"gap_extend_penalty = 30\n"
          b"\n"
          b"      A     C     G     T\n"
          b"A    85  -164   -70  -191\n"
          b"C  -164   100  -151   -70\n"
          b"G   -70  -151   100  -164\n"
          b"T  -191   -70  -164    85\n")

GENERAL = ("#name1\tzstart1\tend1\tname2\tstrand2\tzstart2+\tend2+\tid%\n"
           "chr1\t100\t200\tctgA\t+\t10\t110\t97.5\n"
           "chr1\t300\t420\tctgB\t-\t50\t170\t95.0\n"
           "chr2\t10\t60\tctgA\t+\t0\t50\t99.1\n")

CHAIN = ("#name1\tstart1\tend1\tname2\tstrand2\tstart2\tend2\tscore\n"
         "chr1\t100\t200\tctgA\t+\t10\t110\t5000\n"
         "chr1\t150\t260\tctgA\t+\t400\t510\t4000\n"
         "chr1\t300\t420\tctgA\t+\t210\t330\t6000\n"
         "chr1\t500\t560\tctgA\t-\t20\t80\t3000\n"
         "chr2\t10\t60\tctgA\t+\t0\t50\t2500\n")

TABULAR = ("#name1\tzstart1\tend1\tname2\tstrand2\tzstart2+\tend2+\tcigarx\n"
           "t\t0\t8\tq\t+\t0\t8\t4=1X3=\n")

# HOXD70's background and pair probabilities, as qcode_to_scores takes
# them on its command line
HOXD70 = ["A:.26585", "C:.23415", "AA:.18204", "AC:.01903", "AG:.04510",
          "AT:.01967", "CC:.15508", "CG:.01495"]

QCODE = ("# a quantum code: symbol, then p(A) p(C) p(G) p(T)\n"
         "01 0.70 0.10 0.10 0.10\n"
         "02 0.10 0.70 0.10 0.10\n"
         "03 0.10 0.10 0.70 0.10\n"
         "04 0.10 0.10 0.10 0.70\n"
         "05 1/4 1/4 1/4 1/4\n")


def _hsx(tmp):
    """An hsx index of a two-record FASTA, written by lastz_tpu's hsx."""
    from lastz_tpu.tools.hsx import build_hsx
    fa = os.path.join(tmp, "r.fa")
    with open(fa, "w") as f:
        f.write(">alpha\nACGTACGTAA\nCCGG\n>beta\nTTTTGGGGCCCCAAAA\n")
    out = os.path.join(tmp, "r.hsx")
    build_hsx([fa], out)
    return out


# case: (tool, args ({tmp} is the case's directory), stdin, files)
CASES = {
    "alignment_table": ("alignment_table", ["--require=name1,zstart1"],
                        GENERAL, {}),
    "any_to_qdna": ("any_to_qdna", ["--name=frag"], bytes([1, 2, 3, 4] * 50),
                    {}),
    "any_to_qdna_lines": ("any_to_qdna", ["--striplinebreaks"],
                          b"\x01\x02\n\x03\x04\n" * 20, {}),
    "axt_compare_same": ("axt_compare", ["{tmp}/a.axt", "{tmp}/a.axt"], "",
                         {"a.axt": AXT}),
    "axt_compare_differ": ("axt_compare", ["{tmp}/a.axt", "{tmp}/b.axt"], "",
                           {"a.axt": AXT,
                            "b.axt": AXT.replace("5000", "5001")}),
    "chain_alignments": ("chain_alignments", ["--format=auto"], CHAIN, {}),
    "chain_alignments_penalties": ("chain_alignments",
                                   ["--format=auto", "--chain=5,2"], CHAIN,
                                   {}),
    "cigar_utils": ("cigar_utils", [], "", {}),
    "expand_scores_file": ("expand_scores_file", [], SCORES, {}),
    "fasta_fragments": ("fasta_fragments", ["--fragment=8", "--step=4"],
                        ">chr\nACGTACGTACGTACGTACGT\n>c\nacgtacgtac\n", {}),
    "fasta_softmask_intervals": ("fasta_softmask_intervals", ["{tmp}/m.int"],
                                 ">chr1\nACGTACGT\n",
                                 {"m.int": "chr1 2 4\n"}),
    "fasta_softmask_complement": ("fasta_softmask_intervals",
                                  ["{tmp}/m.int", "--complement", "--mask=N"],
                                  ">chr1\nACGTACGT\n",
                                  {"m.int": "chr1 2 4\n"}),
    "gfa_compare_same": ("gfa_compare", ["{tmp}/a.gfa", "{tmp}/b.gfa"], "",
                         {"a.gfa": "d cmd one\na 1 2 3\nh 4 5 6\n",
                          "b.gfa": "d cmd two\na 1 2 3\nh 4 5 6\n"}),
    "gfa_compare_differ": ("gfa_compare", ["{tmp}/a.gfa", "{tmp}/b.gfa"], "",
                           {"a.gfa": "d cmd one\na 1 2 3\nh 4 5 6\n",
                            "b.gfa": "d cmd two\na 1 2 9\nh 4 5 6\n"}),
    "hassock_hash": ("hassock_hash", ["pig1", "--mod=17"], "", {}),
    "lav_compare_same": ("lav_compare", ["{tmp}/a.lav", "{tmp}/b.lav"], "",
                         {"a.lav": 'd {\n  "prog1 args"\n}\n' + LAV,
                          "b.lav": 'd {\n  "prog2 other"\n}\n' + LAV}),
    "lav_compare_differ": ("lav_compare", ["{tmp}/a.lav", "{tmp}/b.lav"], "",
                           {"a.lav": LAV, "b.lav": LAV.replace("s 7", "s 8")}),
    "lav_sort_score": ("lav_sort", ["--key=score"], LAV, {}),
    "lav_sort_beg1": ("lav_sort", ["--key=beg1"], LAV, {}),
    "maf_sort_pos1": ("maf_sort", ["--key=pos1"], MAF, {}),
    "maf_sort_score": ("maf_sort", ["--key=-score"], MAF, {}),
    "merge_masking_intervals": (
        "merge_masking_intervals", [],
        b"555941 556479\n556153 556663\n555110 555310\n798462 798922\n", {}),
    "pick_from_fasta_hsx": ("pick_from_fasta_hsx",
                            ["{hsx}", "beta", "alpha", "gamma"], "", {}),
    "probabilities_to_scores": ("probabilities_to_scores",
                                ["--hoxd70", "--scaleto=100",
                                 "--nocreator"], "", {}),
    "qcode_to_scores": ("qcode_to_scores",
                        ["--code={tmp}/q.code", "--symmetric", "--nocreator",
                         "--scaleto=100", *HOXD70],
                        "", {"q.code": QCODE}),
    "tabular_to_maf": ("tabular_to_maf", ["--sequences={tmp}/ref.fa"],
                       TABULAR, {"ref.fa": ">t\nACGTACGTAA\n>q\nACGTTCGT\n"}),
}


def _run(argv, stdin, cwd):
    data = stdin.encode() if isinstance(stdin, str) else stdin
    return subprocess.run(argv, input=data, capture_output=True, cwd=cwd,
                          timeout=120)


def test_every_tool_has_a_case():
    assert {c[0] for c in CASES.values()} == set(TOOLS)
    port = {f[:-3] for f in os.listdir(os.path.join(ROOT, "lastz_tpu_torch",
                                                    "tools"))
            if f.endswith(".py")} - {"__init__", "hsx"}
    assert port == set(TOOLS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_output_equals_lastz_tpu(tmp_path, case):
    tool, args, stdin, files = CASES[case]
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    hsx = _hsx(str(tmp_path)) if "{hsx}" in " ".join(args) else ""
    args = [a.format(tmp=tmp_path, hsx=hsx) for a in args]
    host = _run([sys.executable, "-m", f"lastz_tpu.tools.{tool}", *args],
                stdin, ROOT)
    port = _run([sys.executable, "-c", _BLOCKED,
                 f"lastz_tpu_torch.tools.{tool}", *args], stdin, ROOT)
    assert (port.returncode, port.stdout, port.stderr) == \
        (host.returncode, host.stdout, host.stderr)
    # the comparators answer by their exit code alone
    if case.endswith("_same"):
        assert host.returncode == 0, host.stderr[-2000:]
    elif case.endswith("_differ"):
        assert host.returncode != 0
    elif tool != "cigar_utils":
        assert host.returncode == 0 and host.stdout, host.stderr[-2000:]
    if case == "any_to_qdna":
        magic, _, _, _, noff, slen = struct.unpack(">6I", port.stdout[:24])
        assert magic == 0xC4B47197 and slen == 200


def test_cigar_utils_functions():
    """cigar_utils has no command line: its functions, from both
    packages, on test_tools_extra.py's cigars."""
    from lastz_tpu.tools import cigar_utils as host
    from lastz_tpu_torch.tools import cigar_utils as port
    for cigar in ("75M2I30M", "M 75 I 2 M 30", "10=1X5=", "3S10M2D4M"):
        ops = port.parse_cigar(cigar)
        assert ops == host.parse_cigar(cigar)
        assert port.cigar_lengths(ops) == host.cigar_lengths(ops)
        assert port.cigar_to_sam(ops) == host.cigar_to_sam(ops)
        assert port.merge_runs(ops) == host.merge_runs(ops)


def test_create_scores_file_names_the_port():
    with open(os.path.join(ROOT, "lastz_tpu_torch", "tools",
                           "create_scores_file.sh")) as f:
        text = f.read()
    assert "python -m lastz_tpu_torch.cli" in text
    assert "python -m lastz_tpu_torch.tools.expand_scores_file" in text
    assert os.access(os.path.join(ROOT, "lastz_tpu_torch", "tools",
                                  "create_scores_file.sh"), os.X_OK) == \
        os.access(os.path.join(ROOT, "lastz_tpu", "tools",
                               "create_scores_file.sh"), os.X_OK)
