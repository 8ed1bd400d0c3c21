"""The benchmark's files: every name leads to its file, names and units
keep to their characters, and nothing imports JAX or the JAX package
(nor, from the reference, the program)."""

import ast
import json
import os
import re

import pytest

from portbench.bench import ROOT, Cell

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    cell = Cell(w["name"])
    assert cell.config["options"]
    assert os.path.exists(os.path.join(ROOT, "portbench", "configs",
                                       cell.config["scores_file"]))
    # the limits name numbers of the judge the configuration chooses
    assert set(cell.limits["limits"]) <= set(cell.judge().NUMBERS)
    if cell.check_name == "check":
        assert {"lav_unreadable", "rescore_wrong"} <= set(
            cell.limits["limits"])
    assert cell.limits["sample_queries"] >= 1
    for key in ("record_bp", "ortholog_share", "identity", "reverse_share"):
        assert key in cell.traffic
    for m in cell.metrics("per_layer"):
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for c in SPEC["configs"]:
        names += c["reduced"]
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in SPEC["configs"]:
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
               ) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])


def modules(top):
    for dirpath, _, files in os.walk(os.path.join(ROOT, top)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules("portbench")),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    banned = {"jax", "jaxlib", "flax", "lastz_tpu"}
    if os.sep + "reference" + os.sep in path:
        banned.add("lastz_tpu_torch")
    found = set(imported(path)) & banned
    assert not found, f"{path} imports {found}"
