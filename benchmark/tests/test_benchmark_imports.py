"""Nothing the benchmark runs may load JAX or the JAX package; the reference
takes nothing from the port. Import names are compared by their whole top-level
name, so `lip2speech_tpu_torch` is not `lip2speech_tpu`."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests import tiny

BENCH = harness.HERE


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_from_the_port(path):
    assert "lip2speech_tpu_torch" not in _top_level_imports(path)
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


def test_forbidden_names_are_whole(tmp_path):
    assert harness.forbidden_modules(["lip2speech_tpu_torch", "lip2speech_tpu_torch.ops",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["lip2speech_tpu.ops.nn", "jax.numpy", "flax"]) == [
        "flax", "jax", "lip2speech_tpu"]
    src = tmp_path / "probe.py"
    src.write_text("import lip2speech_tpu_torch.ops\nfrom lip2speech_tpu import x\n")
    assert _top_level_imports(src) & set(harness.FORBIDDEN) == {"lip2speech_tpu"}


@pytest.mark.parametrize("name", tiny.CELLS)
def test_rehearsal_loads_no_jax(name):
    """A fresh process runs the cell at the tiny size on the CPU and lists the
    forbidden top-level modules it then holds."""
    code = (f"import json, sys; sys.path.insert(0, {str(harness.ROOT)!r});"
            "from benchmark.tests import tiny; from benchmark import harness;"
            f"r = tiny.rehearse({name!r}, seconds=1.0);"
            "print(json.dumps({'correct': r['correct'], 'bad': harness.forbidden_modules()}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "bad": []}
