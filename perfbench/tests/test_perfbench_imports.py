"""What the benchmark may import and read: no module under perfbench/ has
JAX's or the JAX package's top-level name (compared whole, since the port's
name begins with the JAX package's); only perfbench/system.py and the kind
modules (perfbench/kinds/) import the port; the reference imports nothing
but torch; nothing reads the repo's
older measuring scripts or the TPU-era records."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from perfbench import run

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_by_top_level_name(path):
    assert not top_level_imports(path) & set(run.FORBIDDEN)
    text = path.read_text()
    for old in ("chip_smoke", "BENCH_r0", "MULTICHIP_r0", "BASELINE.json", "infinitam_tpu_torch.bench", "tools/probe"):
        assert old not in text or path.name == "test_perfbench_imports.py"


def test_only_the_system_module_imports_the_port():
    users = {p.relative_to(BENCH).as_posix() for p in MODULES
             if "infinitam_tpu_torch" in top_level_imports(p) and "tests" not in p.parts}
    kinds = {p.relative_to(BENCH).as_posix() for p in (BENCH / "kinds").glob("*.py")}
    assert "system.py" in users and users <= {"system.py"} | kinds
    assert top_level_imports(BENCH / "reference.py") <= {"__future__", "math", "typing", "torch"}


def test_forbidden_names_compare_whole():
    assert "infinitam_tpu" in run.FORBIDDEN
    assert "infinitam_tpu_torch".split(".")[0] not in run.FORBIDDEN
