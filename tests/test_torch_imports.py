"""The port never imports jax or the JAX package: it imports with both
unavailable, and no source file under spartan_tpu_torch/, nor
chip_smoke.py, contains an import of either."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "spartan_tpu_torch"
# _build/ holds build outputs (gitignored), not sources
SOURCES = sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts)
MODULES = sorted("spartan_tpu_torch." + s[:-3].replace("/", ".")
                 .replace(".__init__", "") if s != "__init__.py"
                 else "spartan_tpu_torch" for s in SOURCES)

_JAX_IMPORT = re.compile(r"^\s*(import\s+jax|from\s+jax(\.|\s))", re.M)
# spartan_tpu itself or any of its modules, but not spartan_tpu_torch
_REF_IMPORT = re.compile(
    r"^\s*(import\s+spartan_tpu(?!_torch)\b|from\s+spartan_tpu(?!_torch)\b)",
    re.M)


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_import_in_source(source):
  assert not _JAX_IMPORT.search((PKG / source).read_text())


@pytest.mark.parametrize("source", SOURCES)
def test_no_reference_package_import_in_source(source):
  assert not _REF_IMPORT.search((PKG / source).read_text())


@pytest.mark.parametrize("pattern", [_JAX_IMPORT, _REF_IMPORT],
                         ids=["jax", "spartan_tpu"])
def test_no_forbidden_import_in_chip_smoke(pattern):
  assert not pattern.search((ROOT / "chip_smoke.py").read_text())


@pytest.mark.parametrize("line, hit", [
    ("import spartan_tpu", True), ("import spartan_tpu as sp", True),
    ("  from spartan_tpu.backend import sparse", True),
    ("from spartan_tpu import interop", True),
    ("import spartan_tpu_torch as sp", False),
    ("from spartan_tpu_torch.backend import sparse", False)])
def test_reference_import_pattern(line, hit):
  assert bool(_REF_IMPORT.search(line)) == hit


def test_port_imports_with_jax_unavailable():
  code = ("import sys; sys.modules['jax'] = None\n"
          "sys.modules['spartan_tpu'] = None\n"
          "import importlib\n"
          f"for m in {MODULES!r}: importlib.import_module(m)\n"
          "assert not any(k.split('.')[0] in ('jax', 'spartan_tpu') for k, v "
          "in sys.modules.items() if v is not None)\n"
          "import spartan_tpu_torch as sp\n"
          "sp.initialize(['--device=cpu'])\n"
          "print(float((abs(1 + sp.from_numpy([1.0, -2.0]) * 2)).sum().glom()))\n")
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=120,
                        cwd=str(PKG.parent))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == "6.0"
