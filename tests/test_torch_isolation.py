"""The port stands alone: no module of lastz_tpu_torch, and not
chip_smoke.py, imports lastz_tpu (module level or function local), and
the port's CLI, run with both `jax` and `lastz_tpu` blocked, writes
output byte-equal to lastz_tpu's host path on several option sets."""

import ast
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from lastz_tpu.cli import main as host_main
from lastz_tpu.core import scoring as host_scoring

from test_device_path import _make_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QSCORES = os.path.join(ROOT, "tests", "golden", "quantum", "qscores.txt")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "lastz_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports_of_lastz_tpu(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name == "lastz_tpu" or name.startswith("lastz_tpu."):
                bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} "
                           f"{name}")
    return bad


def test_no_module_of_the_port_imports_lastz_tpu():
    sources = _port_sources()
    assert len(sources) > 40  # the host layers are the port's own
    for mod in ("farm", "distributed"):  # the query tiers too
        assert os.path.join(ROOT, "lastz_tpu_torch", "parallel",
                            f"{mod}.py") in sources
    bad = [b for p in sources for b in _imports_of_lastz_tpu(p)]
    assert bad == []


def test_no_source_of_the_port_reads_a_lastz_tpu_variable():
    """lastz_tpu's LASTZ_TPU_* switches never reroute the port."""
    import re
    read = re.compile(r"""(environ(\.get)?\(|environ\[|getenv\()\s*["']"""
                      r"LASTZ_TPU_")
    bad = []
    for d, _, files in os.walk(os.path.join(ROOT, "lastz_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                with open(os.path.join(d, f)) as fh:
                    bad += [f"{f}:{i}" for i, line in enumerate(fh, 1)
                            if read.search(line)]
    assert bad == []


_BLOCKED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["lastz_tpu"] = None    # and any import of the JAX package
sys.path.insert(0, sys.argv[1])
import lastz_tpu_torch
for m in pkgutil.walk_packages(lastz_tpu_torch.__path__, "lastz_tpu_torch."):
    importlib.import_module(m.name)
from lastz_tpu_torch import cli
from lastz_tpu_torch.align import ydrop_device
ydrop_device.DEFAULT_WIDTH = 128
ydrop_device.DEFAULT_ROWS = 256
ydrop_device.DEFAULT_BATCH = 4
rc = cli.main(sys.argv[2:])
assert "jax.numpy" not in sys.modules
assert not any(m == "lastz_tpu" or m.startswith("lastz_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
sys.exit(rc)
"""


def _tweener_pair(tmp_path, seed=3):
    """Two 2 kbp conserved segments with a 30 bp exact match between
    them, on their diagonal: too weak for the outer search (HSP
    threshold 3000), found by the tweener's inner search (--inner)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    t = alpha[rng.integers(0, 4, 12000)]

    def noise(n):
        return alpha[rng.integers(0, 4, n)]

    def mutate(s):
        s = s.copy()
        m = rng.random(len(s)) < 0.1
        s[m] = alpha[rng.integers(0, 4, int(m.sum()))]
        return s

    q = np.concatenate([noise(500), mutate(t[2000:4000]), noise(300),
                        t[4300:4330], noise(270), mutate(t[4600:6600]),
                        noise(500)])
    paths = []
    for name, s in (("t", t), ("q", q)):
        path = tmp_path / f"{name}.fa"
        path.write_text(f">{name}\n" + bytes(s).decode() + "\n")
        paths.append(str(path))
    return paths


def quantum_pair(tmp_path):
    """_make_pair's small pair with the query as quantum DNA: A, C, G
    and T as the bytes 1 to 4 of QSCORES' alphabet, written by
    lastz_tpu's any_to_qdna.  Returns the target and the query's
    specifier."""
    t, q = _make_pair(tmp_path, n=1500, seed=5)
    with open(q) as f:
        seq = "".join(f.read().split("\n")[1:]).encode()
    qdna = tmp_path / "q.qdna"
    with open(qdna, "wb") as f:
        subprocess.run([sys.executable, "-m", "lastz_tpu.tools.any_to_qdna",
                        "--striplinebreaks"],
                       input=bytes(b"ACGT".index(c) + 1 for c in seq),
                       stdout=f, check=True, cwd=ROOT)
    return t, f"{qdna}[quantum]"


def multi_query_pair(tmp_path, n=1500, seed=5, pieces=4):
    """_make_pair's pair with its query cut into `pieces` records of one
    FASTA (the last one reverse-complemented, so that both strands
    carry alignments)."""
    t, q = _make_pair(tmp_path, n=n, seed=seed)
    with open(q) as f:
        seq = "".join(f.read().split("\n")[1:])
    cut = np.linspace(0, len(seq), pieces + 1).astype(int)
    recs = [seq[a:b] for a, b in zip(cut[:-1], cut[1:])]
    recs[-1] = recs[-1][::-1].translate(str.maketrans("ACGT", "TGCA"))
    with open(q, "w") as f:
        for i, r in enumerate(recs):
            f.write(f">q{i}\n{r}\n")
    return t, q


def repeated_query_pair(tmp_path):
    """_make_pair's pair with four overlapping pieces of its query as
    four queries: with --masking=3 the target's census masks the
    region they share before the fourth query runs."""
    t, q = _make_pair(tmp_path, n=1500, seed=5)
    with open(q) as f:
        seq = "".join(f.read().split("\n")[1:])
    with open(q, "w") as f:
        for i in range(4):
            f.write(f">q{i}\n{seq[50 * i:800 + 50 * i]}\n")
    return t, q


def self_pair(tmp_path):
    """--self: the target alone (a repeat-rich one, so that it aligns
    off its diagonal)."""
    t, _ = _make_pair(tmp_path, n=1500, seed=5)
    with open(t) as f:
        seq = "".join(f.read().split("\n")[1:])
    with open(t, "w") as f:
        f.write(">t\n" + seq + seq[200:900] + seq + "\n")
    return t, None


def hsx_pair(tmp_path):
    """The target as an hsx index written by the port's tools/hsx.py,
    named by its contig."""
    from lastz_tpu_torch.tools.hsx import build_hsx
    t, q = _make_pair(tmp_path, n=1500, seed=5)
    hsx = str(tmp_path / "t.hsx")
    build_hsx([t], hsx)
    return f"{hsx}/t", q


# name: (options, pair); the default LAV run is
# test_torch_pipeline.py::test_runs_with_jax_blocked
OPTION_SETS = {
    "maf": (["--ydrop=3000", "--format=maf"], None),
    "nogapped": (["--nogapped"], None),
    "chain": (["--ydrop=3000", "--chain"], None),
    "tweener": (["--ydrop=3000", "--inner=2000"], _tweener_pair),
    "recoverseeds": (["--ydrop=3000", "--recoverseeds"], None),
    # 12of19's 24 index bits over a 20-bit word: an overweight seed
    "word20": (["--ydrop=3000", "--word=20"], None),
    # --writecapsule={cap}, then the same run through --targetcapsule
    "capsule": (["--ydrop=3000"], None),
    # twin seed hits and a quantum query: the batched search's device
    # x-drop (ops/xdrop_batch.batch_xdrop_device)
    "twins": (["--ydrop=3000", "--twins=20..200"], None),
    "quantum": ([f"Q={QSCORES}"], quantum_pair),
    # the output formats and flows of the copied host surface
    **{f: (["--ydrop=3000", f"--format={f}"], None)
       for f in ("axt", "sam", "cigar", "paf", "general", "differences",
                 "rdotplot")},
    "hitsonly": (["W=8", "T=0", "--nogfextend", "--nogapped"], None),
    "self": (["--ydrop=3000", "--self"], self_pair),
    "census": (["--ydrop=3000", "--masking=3", "--census"],
               repeated_query_pair),
    "inferonly": (["--inferonly", "--scoretype=double"], None),
    "multiquery": (["--ydrop=3000"], multi_query_pair),
    "hsx": (["--ydrop=3000"], hsx_pair),
}


# what shows that a set's output holds an alignment (LAV's "a {" where
# the set is not named)
MARKERS = {"maf": "\ns ", "axt": "\n0 t ", "sam": "\nq\t0\tt\t",
           "cigar": "cigar: q ", "paf": "\tAS:i:", "general": "\tt\t+\t",
           "differences": "\tq\t", "rdotplot": "\nNA\tNA\n",
           "inferonly": "gap_extend_penalty",
           "multiquery": '">q3 (reverse complement)"'}


def _host(args):
    """lastz_tpu's host run of the CLI's arguments, its standard output
    (scoring inference writes there)."""
    buf = io.StringIO()
    saved = host_scoring.SCORE_TYPE  # --scoretype=double sets it
    try:
        with contextlib.redirect_stdout(buf):
            assert host_main(args) == 0
    finally:
        host_scoring.set_score_type(saved)
    return buf.getvalue()


def run_blocked(args):
    """The port's CLI in a child process with `jax` and `lastz_tpu`
    blocked, on the CPU; returns its standard output."""
    env = dict(os.environ, LASTZ_TORCH_DEVICE="cpu")
    env.pop("LASTZ_TPU_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, ROOT, *args],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("opts", list(OPTION_SETS))
def test_runs_with_jax_and_lastz_tpu_blocked(tmp_path, opts):
    options, pair = OPTION_SETS[opts]
    t, q = (pair or (lambda p: _make_pair(p, n=1500, seed=5)))(tmp_path)
    args = [t, *([q] if q else []), *options]
    if opts == "capsule":
        # both packages write a capsule of t, byte for byte the same;
        # then both search q against the port's capsule
        caps = [str(tmp_path / f"{who}.cap") for who in ("port", "host")]
        wrote = [run_blocked([t, f"--writecapsule={caps[0]}"]),
                 _host([t, f"--writecapsule={caps[1]}"])]
        assert wrote[0] == wrote[1].replace(caps[1], caps[0])
        with open(caps[0], "rb") as a, open(caps[1], "rb") as b:
            assert a.read() == b.read()
        args = [f"--targetcapsule={caps[0]}", q, *options]
    host = _host(args)
    assert run_blocked(args) == host
    assert MARKERS.get(opts, "a {") in host
    if opts == "tweener":  # the inner search added an alignment
        assert host.count("a {") > _host(args[:-1]).count("a {")
