"""No module of the benchmark loads JAX or the JAX package, compared by whole
top-level module names (``radioframe_torch`` is not ``radioframe``); the
plain references load nothing of the program either."""

import json
import subprocess
import sys

import pytest

from rfbench import harness

PKG = harness.HERE
MODULES = sorted("rfbench." + ".".join(p.relative_to(PKG).with_suffix("").parts)
                 for p in PKG.rglob("*.py")
                 if p.name != "__init__.py" and "tests" not in p.relative_to(PKG).parts
                 and p.name != "run.py")
REFERENCE = [m for m in MODULES if m.startswith("rfbench.reference.")] + ["rfbench.compare"]

PROBE = """
import importlib, json, sys
sys.path.insert(0, sys.argv[2])
importlib.import_module(sys.argv[1])
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_level(module: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE, module, str(harness.ROOT)],
                         capture_output=True, text=True, check=True, timeout=120)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", MODULES)
def test_module_loads_no_jax(module):
    assert not _top_level(module) & {"jax", "jaxlib", "flax", "radioframe"}


@pytest.mark.parametrize("module", REFERENCE)
def test_reference_loads_nothing_of_the_program(module):
    assert "radioframe_torch" not in _top_level(module)


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "radioframe_torch_x", sys)
    assert "radioframe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "radioframe.core", sys)
    assert "radioframe" in harness.forbidden_modules()


def test_no_source_reads_the_tpu_benchmark():
    for p in PKG.rglob("*.py"):
        if "tests" in p.relative_to(PKG).parts:
            continue
        code = [ln for ln in p.read_text().splitlines()
                if not ln.lstrip().startswith(("#", '"', "'")) and "import" in ln]
        for ln in code:
            for name in ("bench", "chip_smoke", "tools", "probe_"):
                assert f"import {name}" not in ln and f"from {name}" not in ln, (p, ln)
