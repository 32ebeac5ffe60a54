"""Hand-written Hopper kernels, each beside its plain PyTorch version,
registered as XAIF accelerators (impl ``"cuda"``) on import, as
``src/repro/kernels/__init__.py`` registers the Pallas ones. Importing
builds and loads nothing: each kernel is compiled on its first launch."""

from repro_torch.kernels.attention import ops as attention_ops
from repro_torch.kernels.conv1d import ops as conv1d_ops
from repro_torch.kernels.moe import ops as moe_ops
from repro_torch.kernels.paged_attention import ops as paged_attention_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.ssd import ops as ssd_ops

__all__ = ["attention_ops", "conv1d_ops", "moe_ops", "paged_attention_ops",
           "rglru_ops", "ssd_ops"]
