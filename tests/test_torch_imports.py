"""The port never imports jax: it imports with jax unavailable, and no
source file under spartan_tpu_torch/ contains a jax import."""

import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "spartan_tpu_torch"
# _build/ holds build outputs (gitignored), not sources
SOURCES = sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts)
MODULES = sorted("spartan_tpu_torch." + s[:-3].replace("/", ".")
                 .replace(".__init__", "") if s != "__init__.py"
                 else "spartan_tpu_torch" for s in SOURCES)

_JAX_IMPORT = re.compile(r"^\s*(import\s+jax|from\s+jax(\.|\s))", re.M)


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_import_in_source(source):
  assert not _JAX_IMPORT.search((PKG / source).read_text())


def test_port_imports_with_jax_unavailable():
  code = ("import sys; sys.modules['jax'] = None\n"
          "import importlib\n"
          f"for m in {MODULES!r}: importlib.import_module(m)\n"
          "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
          "sys.modules.items() if v is not None)\n"
          "import spartan_tpu_torch as sp\n"
          "sp.initialize(['--device=cpu'])\n"
          "print(float((abs(1 + sp.from_numpy([1.0, -2.0]) * 2)).sum().glom()))\n")
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=120,
                        cwd=str(PKG.parent))
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == "6.0"
