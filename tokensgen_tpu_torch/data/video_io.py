"""Host-side video input and output through cv2 (port of
`tokensgen_tpu/data/video_io.py`).

`load_video` is the inference loader: fps resampling by index arithmetic, a
time window, crop or pad to the output resolution, -> float32
[1, F, H, W, 3] in [-1, 1]. `write_video` writes an mp4 (mp4v). cv2 is
imported when a video is first read or written; without it they raise
ImportError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tokensgen_tpu_torch.data.transforms import ResolutionControl, import_cv2


def read_frames(path: str, indices: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode the given frame indices (or all frames) -> uint8 [F, H, W, 3] RGB."""
    cv2 = import_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    frames = []
    try:
        if indices is None:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        else:
            want = set(int(i) for i in indices)
            last = max(want)
            got = {}
            for idx in range(last + 1):
                ok, frame = cap.read()
                if not ok:
                    break
                if idx in want:
                    got[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames = [got[int(i)] for i in indices if int(i) in got]
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def video_metadata(path: str) -> Tuple[int, float]:
    """(frame count, fps; 30 where the file gives none)."""
    cv2 = import_cv2()
    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
    finally:
        cap.release()


def load_video(path: str, sample_fps: float = 10.0, start_t: float = 0.0, end_t: float = -1.0,
               output_res: Tuple[int, int] = (480, 720), pad_to_fit: bool = False,
               crop_to_fit: bool = True, max_frames: Optional[int] = None) -> np.ndarray:
    """-> float32 [1, F, H, W, 3] in [-1, 1]."""
    n, fps = video_metadata(path)
    start = int(round(start_t * fps))
    end = n if end_t < 0 else min(n, int(round(end_t * fps)))
    idx = np.round(np.arange(start, end, fps / sample_fps)).astype(np.int64)
    idx = idx[idx < n]
    if max_frames is not None:
        idx = idx[:max_frames]
    frames = read_frames(path, idx)
    frames = ResolutionControl(output_res, pad_to_fit=pad_to_fit, crop_to_fit=crop_to_fit)(frames)
    return (frames.astype(np.float32) / 127.5 - 1.0)[None]


def write_video(path: str, video: np.ndarray, fps: float = 10.0) -> None:
    """[F, H, W, 3] float in [-1, 1] or [0, 1] (or uint8) -> mp4."""
    cv2 = import_cv2()
    if video.dtype != np.uint8:
        v = video
        if v.min() < -0.01:
            v = (v + 1.0) / 2.0
        video = (np.clip(v, 0, 1) * 255).astype(np.uint8)
    _, h, w, _ = video.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for frame in video:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def save_videos_grid(path: str, videos: np.ndarray, fps: float = 10.0,
                     n_rows: Optional[int] = None) -> None:
    """Tile a batch of videos [B, F, H, W, 3] (float in [-1, 1] / [0, 1], or
    uint8) into one grid mp4."""
    b = videos.shape[0]
    if n_rows is None:
        n_rows = int(np.floor(np.sqrt(b))) or 1
    n_cols = -(-b // n_rows)
    pad = n_rows * n_cols - b
    if pad:
        videos = np.concatenate([videos, np.zeros_like(videos[:pad])], axis=0)
    f, h, w, c = videos.shape[1:]
    grid = (videos.reshape(n_rows, n_cols, f, h, w, c).transpose(2, 0, 3, 1, 4, 5)
            .reshape(f, n_rows * h, n_cols * w, c))
    write_video(path, grid, fps=fps)
