"""Host-side video I/O and preprocessing.

Port of ``vap_tpu/data/video.py``: decode (``load_video`` :18, OpenCV),
write (``export_to_video`` :52, OpenCV's mp4v writer, atomic), read an
image (``read_image``, the validation rows' ``image_path``), the fps
resample (``get_resample_indices`` :75), [-1, 1] normalisation
(``normalize_video`` :95) and the bucket fit (``resize_frame`` :83,
``resize_to_nearest_bucket_image`` :103, ``resize_to_nearest_bucket``
:114).

The resize computes what ``cv2.resize`` computes on a float32 frame,
without OpenCV: ``INTER_AREA`` when the frame's height shrinks and
``INTER_LINEAR`` otherwise (the rule decides on the height alone, so a width
that grows can get "area" and one that shrinks "linear"). Both are
separable: out = Wy @ frame @ Wx^T per channel, the weight matrices built
as cv2 builds its tables.

OpenCV is imported only inside the codec functions: the port runs where it
is not installed, and raises, naming what is missing, when a video must be
decoded or written and neither codec is there.
"""

from __future__ import annotations

import logging
import os
import random
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("vap_tpu_torch.data.video")

# how many videos each decoder served in this process
DECODES: Dict[str, int] = {"cv2": 0}


def _cv2(what: str):
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{what} needs a video codec: OpenCV (cv2) is not installed") from None
    return cv2


def load_video(path: str, max_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """(frames [F, H, W, 3] uint8 RGB, fps), decoded with OpenCV (JAX's
    fallback; its native libav decoder is not ported)."""
    cv2 = _cv2(f"decoding {path}")
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 16.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    DECODES["cv2"] += 1
    return np.stack(frames), float(fps)


def export_to_video(frames: np.ndarray, path: str, fps: int = 16) -> str:
    """Write frames [F, H, W, 3] (float in [0, 1] or uint8) as an mp4v
    video: a temporary file in the same directory, renamed into place."""
    cv2 = _cv2(f"writing {path}")
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).round().astype(np.uint8)
    out_dir = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(out_dir, exist_ok=True)
    h, w = frames.shape[1:3]
    fd, tmp = tempfile.mkstemp(suffix=".mp4", dir=out_dir)
    os.close(fd)
    try:
        writer = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def canny_edges(frames: np.ndarray, low: int, high: int) -> np.ndarray:
    """OpenCV's Canny edges of each uint8 RGB frame [F, H, W, 3] -> uint8
    [F, H, W] (the control trainer's canny control)."""
    cv2 = _cv2("the canny control")
    return np.stack([cv2.Canny(cv2.cvtColor(f, cv2.COLOR_RGB2GRAY), low, high) for f in frames])


def read_image(path: str) -> np.ndarray:
    """An image file as uint8 RGB [H, W, 3]."""
    cv2 = _cv2(f"reading {path}")
    img = cv2.imread(path)
    if img is None:
        raise ValueError(f"failed to decode image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def get_resample_indices(total_frames: int, original_fps: float,
                         target_fps: float = 16.0) -> List[int]:
    duration = total_frames / max(original_fps, 1e-6)
    target_count = max(int(round(duration * target_fps)), 1)
    return np.linspace(0, total_frames - 1, target_count).round().astype(np.int64).tolist()


# ---------------------------------------------------------------------------
# cv2.resize's weights, as [dst, src] matrices
# ---------------------------------------------------------------------------

def _area_weights(src: int, dst: int) -> np.ndarray:
    """INTER_AREA for a shrink: each output pixel averages the source span
    [i * s, (i + 1) * s), s = src / dst, partial pixels at the span's ends
    weighted by their overlap (cv2's computeResizeAreaTab)."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = (sx1 - fsx1) / cell
        w[dx, sx1:sx2] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return w


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """INTER_LINEAR: half-pixel centres, the source coordinate clamped to
    the image at both ends."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fx = (dx + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        fx -= sx
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= src - 1:
            fx, sx = 0.0, src - 1
        w[dx, sx] += 1.0 - fx
        if fx:
            w[dx, sx + 1] += fx
    return w


def _area_mode_weights(src: int, dst: int) -> np.ndarray:
    """INTER_AREA when an axis grows: cv2 then runs its two-tap linear
    resize on both axes with the "area mode" coefficients, fx = (i + 1) -
    (floor(i * s) + 1) / s taken modulo 1, 0 where it is not positive,
    s = 1 / (dst / src) in double, fx rounded to float32 (cv2's resize.cpp)."""
    inv = dst / src
    scale = 1.0 / inv
    w = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        sx = int(np.floor(dx * scale))
        fx = float(np.float32((dx + 1) - (sx + 1) * inv))
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if sx >= src - 1:
            fx, sx = 0.0, src - 1
        w[dx, sx] += 1.0 - fx
        w[dx, min(sx + 1, src - 1)] += fx
    return w


def resize_weights(h: int, w: int, height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(Wy [height, h], Wx [width, w]) of ``resize_frame``'s cv2 call:
    INTER_AREA when the height shrinks (true area averages when neither
    axis grows, the area-mode taps on both when the width grows), else
    INTER_LINEAR."""
    if h > height:
        weights = _area_mode_weights if w < width else _area_weights
    else:
        weights = _linear_weights
    return weights(h, height), weights(w, width)


def resize_video(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize float frames [F, H, W, C] to [F, height, width, C] float32,
    as ``resize_frame`` does each frame: float32 weights and products, as
    cv2 computes a float32 frame (a row of weights holds at most a few
    taps; the rest are exact zeros)."""
    wy, wx = (torch.from_numpy(m.astype(np.float32))
              for m in resize_weights(*frames.shape[1:3], height, width))
    x = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
    rows = torch.einsum("yh,fhwc->fywc", wy, x)
    return torch.einsum("xw,fywc->fyxc", wx, rows).contiguous().numpy()


def resize_frame(frame: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize one [H, W, C] float frame as ``cv2.resize`` does in
    ``vap_tpu/data/video.py`` ``resize_frame``."""
    return resize_video(np.asarray(frame)[None], height, width)[0]


def normalize_video(frames: np.ndarray) -> np.ndarray:
    """uint8 or float in [0, 1] -> float32 in [-1, 1]."""
    f = frames.astype(np.float32)
    if frames.dtype == np.uint8:
        f = f / 255.0
    return f * 2.0 - 1.0


def resize_to_nearest_bucket_image(image: np.ndarray,
                                   buckets: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Fit an image [H, W, 3] to the aspect-nearest (height, width) bucket."""
    h, w = image.shape[:2]
    aspect = h / w
    bh, bw = min(buckets, key=lambda s: abs(s[0] / s[1] - aspect))
    return resize_video(image[None], bh, bw)[0]


def resize_to_nearest_bucket(frames: np.ndarray, buckets: Sequence[Tuple[int, int, int]],
                             frames_selection: str = "evenly",
                             rng=None) -> Tuple[np.ndarray, bool]:
    """Fit a video to the nearest (frames, height, width) bucket: the
    largest frame bucket not above the video's length (else the smallest),
    the aspect-nearest spatial bucket of it, and the frames chosen by
    ``frames_selection``: "evenly" (linspace), "first", or "random" (a
    contiguous window at a random start). Returns (video, whether the video
    was shorter than its bucket)."""
    f, h, w = frames.shape[:3]
    frame_buckets = sorted({b[0] for b in buckets})
    fb = max([b for b in frame_buckets if b <= f], default=frame_buckets[0])
    spatial = [(bh, bw) for (bf, bh, bw) in buckets if bf == fb]
    aspect = h / w
    bh, bw = min(spatial, key=lambda s: abs(s[0] / s[1] - aspect))

    first_frame_only = f < fb
    if f > fb:
        if frames_selection == "evenly":
            frames = frames[np.linspace(0, f - 1, fb).astype(np.int64)]
        elif frames_selection == "first":
            frames = frames[:fb]
        elif frames_selection == "random":
            start = (rng or random).randint(0, f - fb)
            frames = frames[start:start + fb]
        else:
            raise ValueError(f"invalid frames_selection {frames_selection!r}; "
                             "choose from 'evenly', 'first', 'random'")
    return resize_video(frames, bh, bw), first_frame_only
