"""Checkpoints of parameter and optimizer-state trees.

Port of ``src/repro/ckpt/checkpoint.py`` on one device, in the same on-disk
format, so that each package reads the other's checkpoints: one directory
per step, ``step_%09d``, holding one ``.npy`` per leaf, named by the leaf's
key path joined with ``__`` (dict keys in sorted order, as ``jax.tree``
flattens them), and ``manifest.json``, written last, with the step, the
caller's metadata and each leaf's shape, dtype, ``nbytes`` and ``crc32``.
numpy has no bfloat16: a bf16 leaf is stored as its ``uint16`` bits with
dtype ``"bfloat16"`` in the manifest.

Writes are atomic: the step is written into a dot-prefixed temporary
directory and renamed into place; an existing directory of the same step
is renamed aside before the swap and removed after it, so a crash never
loses the latest checkpoint, and a half-written directory (no manifest)
is never taken for one. :func:`save` with ``async_=True`` copies every leaf
to host memory **before it returns** (the port's optimizers update the
parameter and state tensors in place, so the next step would overwrite a
tensor a writer thread still reads) and writes on a thread.

:func:`restore` checks every leaf against the manifest (a missing file, a
shape or byte count that differs, a CRC mismatch raise a ``ValueError``
saying the checkpoint is corrupt) and places the leaves on the requested
device. The reference's elastic resharding onto another mesh waits for
the tensor-parallel slice. Trees are nested dicts of tensors and Python
numbers; a number (the optimizers' ``step``) is stored as a 0-d array and
restored as the type it has in the tree passed to :func:`restore`.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.sharding.params import tree_map

_SEP = "__"


def _flatten(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs in ``jax.tree`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], prefix + (str(k),))]
    return [(_SEP.join(prefix) or "leaf", tree)]


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """``(array, dtype name)``: a host copy of ``leaf`` that later in-place
    updates of ``leaf`` leave as it is; bf16 as its uint16 bits."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, str(a.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def save(path: str | pathlib.Path, tree: Any, *, step: int,
         metadata: dict | None = None, async_: bool = False):
    """Write ``tree`` as the checkpoint of ``step`` under ``path``. Returns
    a ``join()``-able thread when ``async_`` (every leaf is already copied
    to the host when it returns), else ``None``."""
    path = pathlib.Path(path)
    entries = [(name, *_to_host(leaf)) for name, leaf in _flatten(tree)]

    def write():
        final = path / f"step_{step:09d}"
        tmp = path / f".tmp_step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "metadata": metadata or {},
            "leaves": [{"name": n, "shape": list(a.shape), "dtype": dt,
                        "nbytes": int(a.nbytes), "crc32": _crc(a)}
                       for n, a, dt in entries],
        }
        for n, a, _ in entries:
            np.save(tmp / f"{n}.npy", a)
        # the manifest last: a directory cut off before it is not a
        # checkpoint to latest_step and restore
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            # rename the old step aside, never delete it before the new one
            # is in place; the dot hides it from latest_step's glob
            old = path / f".old_step_{step:09d}"
            if old.exists():
                shutil.rmtree(old)
            final.rename(old)
            tmp.rename(final)
            shutil.rmtree(old)
        else:
            tmp.rename(final)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(path: str | pathlib.Path) -> int | None:
    """The highest step under ``path`` with a manifest, or ``None``."""
    path = pathlib.Path(path)
    if not path.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in path.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _load(d: pathlib.Path, name: str, ent: dict) -> np.ndarray:
    """Leaf ``name`` of checkpoint directory ``d``, checked against its
    manifest entry."""
    f = d / f"{name}.npy"
    if not f.exists():
        raise ValueError(f"checkpoint {d} is corrupt: leaf file {name}.npy "
                         "missing (partial write?)")
    try:
        raw = np.load(f)
    except Exception as e:
        raise ValueError(f"checkpoint {d} is corrupt: leaf {name} unreadable "
                         f"(partial write?): {e}") from e
    if list(raw.shape) != list(ent["shape"]):
        raise ValueError(f"checkpoint {d} is corrupt: leaf {name} has shape "
                         f"{list(raw.shape)}, manifest says {ent['shape']}")
    # checkpoints without nbytes / crc32 skip those checks
    if "nbytes" in ent and int(raw.nbytes) != int(ent["nbytes"]):
        raise ValueError(f"checkpoint {d} is corrupt: leaf {name} is "
                         f"{raw.nbytes} bytes, manifest says {ent['nbytes']} "
                         "(partial write?)")
    if "crc32" in ent:
        crc = _crc(raw)
        if crc != int(ent["crc32"]):
            raise ValueError(f"checkpoint {d} is corrupt: leaf {name} CRC "
                             f"mismatch ({crc:#010x} != "
                             f"{int(ent['crc32']):#010x})")
    return raw


def _leaf(raw: np.ndarray, dtype: str, like: Any, device) -> Any:
    """The restored leaf in the kind of ``like``: a Python number, or a
    tensor on ``device`` (default ``like``'s, if it is a tensor on a real
    device, else the CPU)."""
    if not isinstance(like, torch.Tensor):
        return type(like)(raw.item())
    t = torch.from_numpy(np.ascontiguousarray(raw))
    if dtype == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    dev = device if device is not None else (
        like.device if like.device.type != "meta" else "cpu")
    return t.to(dev)


def restore(path: str | pathlib.Path, tree_like: Any, *,
            step: int | None = None, device=None) -> tuple[Any, int, dict]:
    """``(tree, step, metadata)``: the checkpoint of ``step`` (default the
    latest) in the structure of ``tree_like``, whose leaves may be meta
    tensors. Tensor leaves land on ``device``, or where the like-leaf is.
    Raises ``FileNotFoundError`` without a checkpoint, ``ValueError`` on a
    structure mismatch or a corrupt leaf."""
    path = pathlib.Path(path)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    d = path / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    pairs = _flatten(tree_like)
    want = {e["name"] for e in manifest["leaves"]}
    have = {n for n, _ in pairs}
    if want != have:
        raise ValueError(f"checkpoint/tree mismatch: only-ckpt={want - have} "
                         f"only-tree={have - want}")
    entry_of = {e["name"]: e for e in manifest["leaves"]}
    leaves = iter([_leaf(_load(d, n, entry_of[n]), entry_of[n]["dtype"],
                         like, device) for n, like in pairs])
    return tree_map(lambda _: next(leaves), tree_like), step, \
        manifest["metadata"]
