"""Hand-written Hopper kernels, each beside its plain PyTorch version, and
registered as ``torch.ops.mdfd`` custom ops (``library.py``)."""
from . import library  # noqa: F401  (registers the ops)
