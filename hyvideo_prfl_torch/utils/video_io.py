"""Frames to files (hyvideo_prfl_tpu/utils/video_io.py:155-193; its video
readers and resize wait for the preprocess CLIs).

mp4 through imageio, else OpenCV, where either imports and has a codec;
a single frame as an image through imageio, else PIL; otherwise the
frames go to ``<stem>_frames.npy`` as uint8 [T, H, W, 3] and a log line
says so (a card's machine may have none). Every import of imageio, PIL
or OpenCV happens inside the function that needs it.
"""

from __future__ import annotations

import logging
import math
import os
import numpy as np


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
