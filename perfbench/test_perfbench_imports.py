"""What the benchmark may import: nothing under ``perfbench/`` imports
JAX or the JAX package ``repro`` (top-level module names compared whole,
so ``repro_torch`` is not ``repro``), and the reference imports nothing of
the program. A scan of the sources' syntax trees, ``import_module`` calls
with a literal name included."""
import ast
import json
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parent
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """Top-level names of every module a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module"):
            yield node.args[0].value.split(".")[0]


def test_scan_sees_the_sources():
    assert HERE / "run.py" in SOURCES and len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(imported(path))


def test_scan_finds_a_forbidden_import(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import grow\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n"
                 "import repro_torch\n")
    assert set(imported(f)) == {"jax", "repro", "importlib", "flax",
                                "repro_torch"}


def test_loaded_modules_are_compared_by_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch.core.grow", "numpy",
                                      "jaxtyping", "reprolib"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro.core", "flax",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]


@pytest.mark.parametrize("loaded", [[], ["jax"]])
def test_the_result_is_withheld_once_jax_is_loaded(loaded, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(harness, "run", lambda args, t0: {"correct": True})
    monkeypatch.setattr(harness, "forbidden_modules", lambda: loaded)
    rc = harness.main(["--workload", "gpt2m.ligo", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr().out
    if loaded:
        assert rc != 0 and out == ""
    else:
        assert rc == 0 and json.loads(out) == {"correct": True}
