"""Video stream I/O: the counterpart of ``yolo_quantization_tpu/data/video.py``
(darknet's OpenCV open_video_stream, without a display window).

OpenCV, imported on first use, decodes and encodes the containers; frames
cross the boundary as float32 RGB HWC in [0, 1], the image convention of
``data/image.py``.  The output is an annotated video file.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("video I/O needs OpenCV (cv2), which is not installed") from e
    return cv2


def read_video(path: str) -> tuple[Iterator[np.ndarray], float, tuple[int, int]]:
    """Open a video file: (frame iterator, fps, (width, height)); frames are
    float32 RGB in [0, 1]."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def frames():
        try:
            while True:
                ok, bgr = cap.read()
                if not ok:
                    return
                yield bgr[:, :, ::-1].astype(np.float32) / 255.0
        finally:
            cap.release()

    return frames(), float(fps), (w, h)


class VideoWriter:
    """Write float32 RGB [0, 1] frames to a video file (mp4v for .mp4,
    MJPG otherwise)."""

    def __init__(self, path: str, fps: float, size_wh: tuple[int, int]):
        cv2 = _cv2()
        fourcc = cv2.VideoWriter_fourcc(*("mp4v" if path.endswith(".mp4") else "MJPG"))
        self._w = cv2.VideoWriter(path, fourcc, fps, size_wh)
        if not self._w.isOpened():
            raise RuntimeError(f"cannot open video writer for {path}")
        self.path = path
        self.frames = 0

    def write(self, rgb: np.ndarray) -> None:
        bgr = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)[:, :, ::-1]
        self._w.write(np.ascontiguousarray(bgr))
        self.frames += 1

    def close(self) -> None:
        self._w.release()


def synthesize_clip(path: str, n_frames: int = 24, size: int = 160, fps: float = 12.0) -> str:
    """Write a small test clip, a bright rectangle moving along the
    diagonal, so the video path runs without external media."""
    w = VideoWriter(path, fps, (size, size))
    for t in range(n_frames):
        im = np.full((size, size, 3), 0.12, np.float32)
        c = int((0.2 + 0.6 * t / max(n_frames - 1, 1)) * size)
        half = size // 8
        im[max(c - half, 0):c + half, max(c - half, 0):c + half] = (0.95, 0.3, 0.2)
        w.write(im)
    w.close()
    return path
