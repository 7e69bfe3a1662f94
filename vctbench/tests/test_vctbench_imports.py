"""What the benchmark imports, in fresh interpreters: the harness loads no
module whose top-level name is jax, jaxlib, flax or vct_tpu (compared
whole: vct_tpu_torch is the program), and the inputs and every reference
a configuration names (vctbench/configs/*.json, spec.reference_module)
load nothing of vct_tpu_torch either.  Without a card, run.py exits 1 and
prints no result."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "vctbench"


def _loaded(*modules) -> set:
    code = ("import sys, json\n"
            + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _loaded("vctbench.run", "vctbench.harness", "vctbench.program",
                  "vctbench.calibrate", "vctbench.reference.pipeline")
    assert "vct_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "vct_tpu"}


def _references() -> set:
    """The reference module of every configuration file."""
    from vctbench import spec
    return {spec.reference_module(json.loads(p.read_text()))
            for p in (PKG / "configs").glob("*.json")}


def test_reference_and_inputs_load_nothing_of_the_program():
    refs = _references()
    assert "vctbench.reference.pipeline" in refs
    top = _loaded(*sorted(refs), "vctbench.inputs.scene",
                  "vctbench.inputs.traffic")
    assert not top & {"vct_tpu_torch", "vct_tpu", "jax", "jaxlib", "flax"}


def _sources(*dirs):
    for d in dirs:
        if (PKG / f"{d}.py").exists():
            yield PKG / f"{d}.py"
        yield from (p for p in (PKG / d).rglob("*.py"))


def _strings(tree) -> list:
    """The string constants of a module that are not docstrings."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_source_names_the_jax_side():
    """No module of the benchmark (tests apart) imports vct_tpu or jax,
    or names a file of the JAX package or a BENCH_/FIDELITY_ record in
    its code."""
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|vct_tpu)\b(?!_)",
                     re.M)
    files = [p for p in PKG.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        text = p.read_text()
        assert not bad.search(text), p
        for s in _strings(ast.parse(text)):
            assert not re.search(r"BENCH_r|FIDELITY_r|vct_tpu/", s), (p, s)
    packages = {m.split(".")[1] for m in _references()}
    for p in _sources("inputs", *sorted(packages)):
        assert "import vct_tpu_torch" not in p.read_text(), p
        assert "from vct_tpu_torch" not in p.read_text(), p


def test_run_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "vctbench.run", "--workload",
         "sponza256.walk", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_takes_one_intra_op_thread():
    code = ("import vctbench.run, torch; "
            "print(torch.get_num_threads())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "8"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1"]
