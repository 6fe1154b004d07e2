"""Video files on the host (hyvideo_prfl_tpu/utils/video_io.py).

Reading, for the preprocess CLI: ``read_video`` decodes an mp4 (a path or
an http(s) URL) through OpenCV, resamples it to a target fps, skips
``start_frame`` source frames and keeps 4n+1 frames (the VAE's temporal
stride); ``target_size_for`` and ``resize_center_crop`` size a clip as
the reference's preprocess does; ``to_model_range`` maps uint8 to [-1, 1].
The JAX reader tries imageio's pyav plugin first and falls through to the
same OpenCV decode where pyav is absent; the card's machine has OpenCV and
no imageio, so the port decodes through OpenCV always.

Writing: mp4 through imageio, else OpenCV, where either imports and has a
codec; a single frame as an image through imageio, else PIL; otherwise the
frames go to ``<stem>_frames.npy`` as uint8 [T, H, W, 3] and a log line
says so (a card's machine may have none). Every import of imageio, PIL
or OpenCV happens inside the function that needs it.
"""

from __future__ import annotations

import logging
import math
import os
import tempfile
from typing import Optional, Tuple

import numpy as np


def read_video(path: str, num_frames: Optional[int] = None,
               target_fps: Optional[float] = None,
               start_frame: int = 0) -> Tuple[np.ndarray, float]:
    """An mp4 (a local path or an http(s) URL) -> ([T, H, W, 3] uint8 RGB,
    fps): ``start_frame`` source frames skipped, then resampled to
    ``target_fps`` (every fps / target_fps-th frame), cut to ``num_frames``
    and to 4n+1 frames."""
    src = path
    if path.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(urllib.request.Request(path), timeout=20) as resp:
            src = resp.read()
    frames, fps = _read_video_cv2(src)
    if start_frame:
        frames = frames[start_frame:]
    if target_fps and abs(target_fps - fps) > 1e-3:
        idx = np.arange(0, len(frames), fps / target_fps).astype(np.int64)
        frames = frames[idx[idx < len(frames)]]
        fps = target_fps
    if num_frames is not None:
        frames = frames[:num_frames]
    t_aligned = (len(frames) - 1) // 4 * 4 + 1
    return np.asarray(frames[:t_aligned]), fps


def _read_video_cv2(src) -> Tuple[np.ndarray, float]:
    """OpenCV's decode of a path or of mp4 bytes (written to a temporary
    file first) -> ([T, H, W, 3] uint8 RGB, fps; 30 where the file gives
    none)."""
    import cv2

    tmp = None
    path = src
    if isinstance(src, bytes):
        tmp = tempfile.NamedTemporaryFile(suffix=".mp4", delete=False)
        tmp.write(src)
        tmp.close()
        path = tmp.name
    try:
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cv2 cannot open video: {path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if not frames:
            raise IOError(f"no frames decoded from {path}")
        return np.stack(frames), float(fps)
    finally:
        if tmp is not None:
            os.unlink(tmp.name)


def target_size_for(h: int, w: int, resolution: int, aspect_ratio: float) -> Tuple[int, int]:
    """(height, width) for a clip of source size (h, w), as the reference
    sizes it: the short side scaled to ``resolution``, both sides rounded
    up to a multiple of 32, each capped at ceil32(resolution * aspect_ratio)."""
    def ceil32(v):
        return int(-(-int(v) // 32) * 32)

    scale = resolution / min(h, w)
    rh, rw = ceil32(int(h * scale)), ceil32(int(w * scale))
    max_r = ceil32(resolution * aspect_ratio)
    return min(rh, max_r), min(rw, max_r)


def resize_center_crop(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """[T, h, w, 3] -> [T, height, width, 3]: an aspect-preserving resize
    (OpenCV INTER_AREA) that covers the target, then a centre crop."""
    import cv2

    t, h, w, _ = frames.shape
    scale = max(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.empty((t, height, width, 3), frames.dtype)
    y0, x0 = (nh - height) // 2, (nw - width) // 2
    for i in range(t):
        r = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_AREA)
        out[i] = r[y0:y0 + height, x0:x0 + width]
    return out


def to_model_range(frames_uint8: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> fp32 [-1, 1]."""
    return frames_uint8.astype(np.float32) / 127.5 - 1.0


def to_uint8(video_m1_1) -> np.ndarray:
    """[..., 3] in [-1, 1] (numpy or a tensor on any device) -> uint8."""
    if hasattr(video_m1_1, "detach"):
        video_m1_1 = video_m1_1.detach().float().cpu().numpy()
    return ((np.clip(video_m1_1, -1, 1) + 1.0) * 127.5).astype(np.uint8)


def _write_mp4(frames: np.ndarray, path: str, fps: int) -> bool:
    try:
        import imageio

        with imageio.get_writer(path, fps=fps, codec="libx264", quality=8) as w:
            for f in frames:
                w.append_data(f)
        return True
    except Exception as e:  # noqa: BLE001 -- a missing module or codec backend
        logging.warning("imageio could not write %s: %s", path, e)
    try:
        import cv2

        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return True
    except Exception as e:  # noqa: BLE001 -- a missing module or codec backend
        logging.warning("OpenCV could not write %s: %s", path, e)
    return False


def frames_path(path: str) -> str:
    return os.path.splitext(path)[0] + "_frames.npy"


def cache_video(video_m1_1, path: str, fps: int = 15) -> str:
    """[T, H, W, 3] in [-1, 1] -> ``path`` (mp4), or its ``_frames.npy``
    where no writer works; returns the file written."""
    frames = to_uint8(video_m1_1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if _write_mp4(frames, path, fps):
        return path
    out = frames_path(path)
    np.save(out, frames)
    logging.info("no mp4 writer; wrote uint8 frames %s to %s", frames.shape, out)
    return out


def save_videos_grid(videos, path: str, fps: int = 15) -> str:
    """[B, T, H, W, 3] in [-1, 1] -> one grid video of ceil(sqrt(B)) rows
    (``cache_video``)."""
    if hasattr(videos, "detach"):
        videos = videos.detach().float().cpu().numpy()
    b, t, h, w, c = videos.shape
    n_rows = int(math.ceil(math.sqrt(b)))
    n_cols = int(math.ceil(b / n_rows))
    grid = np.zeros((t, n_rows * h, n_cols * w, c), np.float32)
    for i in range(b):
        r, col = divmod(i, n_cols)
        grid[:, r * h:(r + 1) * h, col * w:(col + 1) * w] = videos[i]
    return cache_video(grid, path, fps=fps)


def _write_image(img: np.ndarray, path: str) -> bool:
    try:
        import imageio

        imageio.imwrite(path, img)
        return True
    except Exception as e:  # noqa: BLE001 -- a missing module or format plugin
        logging.warning("imageio could not write %s: %s", path, e)
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
        return True
    except Exception as e:  # noqa: BLE001 -- a missing module or format plugin
        logging.warning("PIL could not write %s: %s", path, e)
    return False


def cache_image(image_m1_1, path: str) -> str:
    """[H, W, 3] in [-1, 1] -> an image file through imageio, else PIL, or
    its ``_frames.npy`` (one frame) where neither writes it; returns the
    file written."""
    img = to_uint8(image_m1_1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if _write_image(img, path):
        return path
    out = frames_path(path)
    np.save(out, img[None])
    logging.info("no image writer; wrote uint8 frames %s to %s", img[None].shape, out)
    return out
