"""Build a hand-written CUDA kernel into a shared library, on first use.

Every kernel of the port is one CUDA C++ source under its package's
``csrc/`` with plain ``extern "C"`` entries. :func:`build` compiles it with
``nvcc`` for ``sm_90a`` into the ``build/`` directory beside that package
(ignored by git), keyed by the hash of the source, so an edited source is
rebuilt and an unchanged one is reused. The compiler's resource report
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``.log``. The kernel modules bind the library with ``ctypes``.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/ with the CUDA toolkit on the card's machine")


def build(src: pathlib.Path, name: str, build_dir: pathlib.Path) -> pathlib.Path:
    """Compile ``src`` into ``build_dir/lib<name>_<hash>.so`` unless that
    library exists, and return its path. Raises with the compiler's errors
    when ``nvcc`` fails."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = build_dir / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(out.stdout + out.stderr)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({out.returncode}):\n"
                           f"{out.stderr}")
    os.replace(tmp, lib)        # atomic: a concurrent build sees all or none
    return lib
