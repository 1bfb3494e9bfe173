"""Resolution control and crop transforms, host-side numpy and cv2 (port of
`tokensgen_tpu/data/transforms.py`).

* `ResolutionControl`: aspect-preserving resize then pad (or crop) to a
  target, with an inverse that maps generated frames back;
* `resize_for_rectangle_crop`: resize so the target rectangle is covered,
  then center-crop.

Resizes go through ``cv2.resize`` with INTER_AREA when shrinking and
INTER_LINEAR when growing, as the JAX package does: its rounding on uint8
frames is what the loaded source video is held to. Frames are numpy
[F, H, W, C], uint8 or float. cv2 is imported at the first resize.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def import_cv2():
    """cv2, or an ImportError that says what needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading, resizing and writing video needs OpenCV (`cv2`), which "
                          "is not installed") from e
    return cv2


def _resize(frames: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    cv2 = import_cv2()
    h, w = size_hw
    return np.stack([
        cv2.resize(f, (w, h), interpolation=cv2.INTER_AREA if f.shape[0] > h else cv2.INTER_LINEAR)
        for f in frames
    ])


def resize_for_rectangle_crop(frames: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Scale so the target rectangle is fully covered, then center crop."""
    th, tw = target_hw
    h, w = frames.shape[1:3]
    if w / h > tw / th:
        scale = th / h
        nh, nw = th, int(round(w * scale))
    else:
        scale = tw / w
        nh, nw = int(round(h * scale)), tw
    frames = _resize(frames, (nh, nw))
    top = (nh - th) // 2
    left = (nw - tw) // 2
    return frames[:, top:top + th, left:left + tw]


class ResolutionControl:
    """Aspect-preserving resize + pad (or crop) to a fixed resolution, invertible."""

    def __init__(self, target_hw: Tuple[int, int], pad_to_fit: bool = False,
                 crop_to_fit: bool = True, fill: int = 0):
        self.target_hw = target_hw
        self.pad_to_fit = pad_to_fit
        self.crop_to_fit = crop_to_fit
        self.fill = fill
        self._orig_hw: Optional[Tuple[int, int]] = None
        self._pad: Optional[Tuple[int, int, int, int]] = None

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        self._orig_hw = frames.shape[1:3]
        th, tw = self.target_hw
        if self.crop_to_fit and not self.pad_to_fit:
            return resize_for_rectangle_crop(frames, self.target_hw)
        # fit inside, then pad
        h, w = frames.shape[1:3]
        scale = min(th / h, tw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        frames = _resize(frames, (nh, nw))
        pt = (th - nh) // 2
        pb = th - nh - pt
        pl = (tw - nw) // 2
        pr = tw - nw - pl
        self._pad = (pt, pb, pl, pr)
        return np.pad(frames, ((0, 0), (pt, pb), (pl, pr), (0, 0)), constant_values=self.fill)

    def inverse(self, frames: np.ndarray) -> np.ndarray:
        if self._pad is not None:
            pt, pb, pl, pr = self._pad
            h, w = frames.shape[1:3]
            frames = frames[:, pt:h - pb if pb else h, pl:w - pr if pr else w]
        if self._orig_hw is not None:
            frames = _resize(frames, self._orig_hw)
        return frames
