"""Device resolution for the port's entry points.

``device=None`` means the card: it resolves to ``cuda`` and raises when no
CUDA device is present. The CPU is used only when a caller asks for it
(``device="cpu"``), as the tests do; nothing continues on the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` and any ``cuda`` device require ``torch.cuda.is_available()``
    and raise ``RuntimeError`` without it. A CUDA device comes back with
    its index (``cuda`` is the current device), so it compares equal to a
    tensor's ``.device``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
