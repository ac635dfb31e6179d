"""Pluggable face detection for the preprocessing pipelines and the raw-video
loader (numpy; cv2 imported only by YuNet, at construction).

The port's copy of the JAX package's ``data/face_detect.py``. The reference
crops UADFV faces with ``facenet_pytorch``'s MTCNN and runs FakeAVCeleb on
whole frames; neither MTCNN nor cv2's cascade models are available, so
detection is a strategy:

* ``center`` — a centred square box, deterministic (on portrait face videos
  such as UADFV it approximates the face region);
* ``yunet`` — ``cv2.FaceDetectorYN`` over a user's ONNX model file;
* ``none`` — the whole frame (the FakeAVCeleb behaviour);
* any callable ``frame_rgb -> (x1, y1, x2, y2) | None``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

Box = Tuple[int, int, int, int]


def center_box_detector(frame: np.ndarray) -> Optional[Box]:
    h, w = frame.shape[:2]
    side = min(h, w)
    x1 = (w - side) // 2
    y1 = (h - side) // 2
    return (x1, y1, x1 + side, y1 + side)


def whole_frame_detector(frame: np.ndarray) -> Optional[Box]:
    h, w = frame.shape[:2]
    return (0, 0, w, h)


class YuNetDetector:
    """cv2.FaceDetectorYN wrapper (requires an ONNX model file)."""

    def __init__(self, model_path: str, score_threshold: float = 0.6):
        import cv2

        self._cv2 = cv2
        self._det = cv2.FaceDetectorYN_create(model_path, "", (0, 0), score_threshold)

    def __call__(self, frame: np.ndarray) -> Optional[Box]:
        h, w = frame.shape[:2]
        self._det.setInputSize((w, h))
        _, faces = self._det.detect(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))
        if faces is None or len(faces) == 0:
            return None
        x, y, bw, bh = faces[0][:4]  # first (highest-score) face, like MTCNN boxes[0]
        return (int(x), int(y), int(x + bw), int(y + bh))


def make_detector(kind: str = "center", *, model_path: Optional[str] = None) -> Callable:
    if callable(kind):
        return kind
    if kind == "center":
        return center_box_detector
    if kind == "none":
        return whole_frame_detector
    if kind == "yunet":
        if not model_path:
            raise ValueError("yunet detector requires --detector_model path to an ONNX file")
        return YuNetDetector(model_path)
    raise ValueError(f"unknown detector kind {kind!r}")


def crop_with_margin(frame: np.ndarray, box: Box, margin: int = 20) -> np.ndarray:
    """Crop box +/- margin, clamped to the frame (UADFV_face_dataset.py:33-38)."""
    h, w = frame.shape[:2]
    x1, y1, x2, y2 = box
    x1 = max(0, int(x1) - margin)
    y1 = max(0, int(y1) - margin)
    x2 = min(w, int(x2) + margin)
    y2 = min(h, int(y2) + margin)
    return frame[y1:y2, x1:x2]
