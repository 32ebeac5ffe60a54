"""Weight bridge: the JAX package's parameter tree as the port's tree.

:func:`params_from_numpy` takes a params tree whose leaves are numpy arrays
(the caller converts the JAX arrays with ``np.asarray``) and returns a tree
of torch tensors with the same keys and layout, so both packages can run on
the same weights: every family's tree, the VLM family's (internvl2) with
the transformer's layout included, since the port's ``registry.decls``
keeps the reference's keys and shapes for each. This module imports no
JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.sharding.params import tree_map


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the bits through uint16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_numpy(tree: Any, device) -> Any:
    """numpy params tree -> torch tree on ``device`` (same keys, shapes and
    dtypes; bfloat16 leaves keep their bits)."""
    device = torch.device(device)
    return tree_map(lambda a: _tensor(a).to(device), tree)
