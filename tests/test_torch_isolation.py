"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro``.

Module names are matched exactly or by their dotted prefix (``repro`` or
``repro.*``), so ``repro_torch`` itself does not count as the JAX package.
"""

import ast
import importlib.util
import pathlib
import subprocess
import sys

import pytest

# torch is looked for, not imported: the import check below loads the port
# in a child process and leaves this worker without torch
if importlib.util.find_spec("torch") is None:
    pytest.skip("torch is not installed", allow_module_level=True)

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
            # `from repro import x` imports repro.x
            mods += [f"{node.module}.{a.name}" for a in node.names]
    return mods


def _sources() -> list[pathlib.Path]:
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_prefix_check_tells_the_packages_apart():
    assert _forbidden("repro") and _forbidden("repro.serve.engine")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.serve")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_every_module_loads_no_jax_and_no_reference():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'repro')"
        " or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
