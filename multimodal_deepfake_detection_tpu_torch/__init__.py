"""PyTorch + CUDA port of ``multimodal_deepfake_detection_tpu`` for NVIDIA Hopper.

The JAX package next to this one is the reference; every module here mirrors
its counterpart's path (``models/fold.py`` <-> ``models/fold.py``) so a reader
can find each pair. This package imports ``torch`` and numpy, never JAX.

* :mod:`.models` — Xception and ResNet-18 (live-BN eval), BN folding, the
  w8a8 trees, LSTM/ArcFace heads, the AU models, and the serving engines
  (``VisualScorer``, ``AudioScorer``, ``AVScorer``, ``AUFaceScorer``,
  ``AUPatchScorer``).
* :mod:`.ops` — NHWC conv/pool/linear wrappers over ``torch.nn.functional``,
  bilinear resize, the explicit-loop LSTM and BiLSTM, the MFCC frontend,
  int8 primitives, and :mod:`.ops.kernels` — the
  hand-written Hopper kernels with their plain PyTorch versions.
* :mod:`.core` — dtype helpers and the numpy-only ``.npz`` bundle format
  shared with the JAX package.
* :mod:`.utils.jax_weights` — JAX param/state trees <-> the port's modules.
* :mod:`.cli.serve` — ``--engine visual|audio|av|au_face|au_patch`` batch
  scoring to JSONL.
"""

__version__ = "0.1.0"
