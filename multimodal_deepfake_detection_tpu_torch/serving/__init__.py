"""Online serving: dynamic micro-batching and an HTTP scoring daemon.

Counterpart of ``multimodal_deepfake_detection_tpu/serving/`` (which imports
no JAX, but the port keeps its own copy): single-clip requests are
coalesced into micro-batches whose (batch, time) axes are padded to a small
fixed bucket grid, over the port's engines (``models/serve.py``) or its
exported programs (``models/artifact.py``).
"""
from .batcher import (
    AudioAdapter,
    AUFaceAdapter,
    AUPatchAdapter,
    AVAdapter,
    MicroBatcher,
    VisualAdapter,
)
from .daemon import ServingDaemon

__all__ = [
    "MicroBatcher",
    "VisualAdapter",
    "AudioAdapter",
    "AUFaceAdapter",
    "AUPatchAdapter",
    "AVAdapter",
    "ServingDaemon",
]
