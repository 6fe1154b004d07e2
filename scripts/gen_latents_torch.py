"""Videos -> the latent cache the trainers read, on the card (the port's
counterpart of scripts/gen_latents.py, after the reference's
gen_wanx_latent.py).

For each clip of the input JSON list (``source_id``, ``video_path``,
captions): decode it on the host (OpenCV), resample to ``extract_fps``,
skip ``start_idx`` frames, keep up to ``sample_n_frames`` 4n+1 frames,
resize and centre-crop (the short side to ``resolution``, 32-aligned and
capped at ``resolution * aspect_ratio``; or a fixed ``height``/``width``),
then the VAE encode of the clip (whole up to 33 frames, streamed above),
the encode of the ``f1_black`` video ([first frame, zeros...]), the CLIP
image tower on the first frame (resized on the host by OpenCV's
INTER_CUBIC, as the JAX package does) and, where umT5 weights and a
tokenizer are configured, the short and long captions. It writes what
the JAX CLI writes: ``latents/{id}.npy`` and ``{id}_f1_black.npy``
[1, 16, T, H/8, W/8], ``{id}_img_clip.npy`` [1, 257, 1280],
``{id}_textshort.npy``/``{id}_textlong.npy`` [1, n, 4096] (without T5 the
text paths are left out; ``scripts/encode_captions_torch.py`` fills them
in), and ``meta_v1/{id}_meta_v1.json``: the clip's record, the paths and
``latent_shape``. A clip already processed is skipped; a clip that fails
is logged and passed over. Everything runs in fp32 (the config's
``precision`` is not read, as in the JAX CLI).

    python3 scripts/gen_latents_torch.py --config configs/pre_480.yaml [--device cuda]

The config is the reference's flat ``pre_*.yaml`` (``json_path``,
``vae_path``, ``image_encoder_path``, ``text_encoder_path``,
``tokenizer_path``, ``sample_n_frames``, ``extract_fps``, ``resolution`` +
``aspect_ratio``, ``start_idx``) or the nested one
(``extra_model.{vae, image_encoder, text_encoder}.*``, ``input_json``,
``height``/``width``). The weights are the reference ``.pth`` files
(``Wan2.1_VAE.pth``, the whole-CLIP file, the umT5 file); an orbax
directory of the JAX package is refused.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hyvideo_prfl_torch.configs import load_config  # noqa: E402
from hyvideo_prfl_torch.models import clip as clip_mod  # noqa: E402
from hyvideo_prfl_torch.models import vae as vae_mod  # noqa: E402
from hyvideo_prfl_torch.utils import encoders  # noqa: E402
from hyvideo_prfl_torch.utils.video_io import (  # noqa: E402
    read_video, resize_center_crop, target_size_for, to_model_range)
from scripts.encode_captions_torch import (  # noqa: E402
    check_device, make_t5_embedder, refuse_orbax)

# clips of more frames are encoded streaming (the reference's 1 + 4k chunks)
STREAM_OVER_FRAMES = 33


def encode_clip_data(vae, clip, video_m1_1: np.ndarray,
                     stream_over_frames: int = STREAM_OVER_FRAMES, times=None):
    """video [T, H, W, 3] in [-1, 1] (numpy) -> (latents [1, C, T', h, w],
    f1_black latents, CLIP features [1, tokens, dim]) as fp32 numpy, run on
    the VAE's device. ``times``, where given, gets the seconds of the
    encode, the f1_black encode and CLIP (each ends in a copy to the host)."""
    dev = vae.conv1.weight.device
    v = torch.from_numpy(np.ascontiguousarray(video_m1_1, np.float32))[None].to(dev)
    if v.shape[1] > stream_over_frames:
        def enc(x):
            return vae_mod.encode_streaming(vae, x)
    else:
        enc = vae.encode

    def to_ref(z):  # [1, T, H, W, C] -> the reference's [1, C, T, H, W]
        return z.permute(0, 4, 1, 2, 3).cpu().numpy()

    t0 = time.perf_counter()
    latents = to_ref(enc(v))
    t1 = time.perf_counter()
    f1 = torch.zeros_like(v)  # [first frame, zeros...]
    f1[:, 0] = v[:, 0]
    del v
    f1_black = to_ref(enc(f1))
    del f1
    t2 = time.perf_counter()
    img = clip_mod.preprocess_frames_host(video_m1_1[:1], clip.cfg.image_size)
    img_clip = clip(torch.from_numpy(img).to(dev)).cpu().numpy()
    if times is not None:
        times.update(encode_s=t1 - t0, f1_black_s=t2 - t1, clip_s=time.perf_counter() - t2)
    return latents, f1_black, img_clip


def resolve_config(config):
    """Both config schemas -> one dict: the nested keys (input_json,
    height/width, extra_model.*.params_path) and the reference's flat
    pre_*.yaml keys (json_path, *_path, sample_n_frames, extract_fps,
    resolution [min side] + aspect_ratio, start_idx)."""
    get = config.get
    gp = config.get_path
    res = get("resolution")
    if isinstance(res, (list, tuple)):
        res = res[0] if res else None
    return dict(
        save_dir=get("save_dir", "latent_cache"),
        input_json=get("input_json") or get("json_path"),
        num_frames=int(get("num_frames") or get("sample_n_frames") or 81),
        fps=get("extract_fps") or get("fps") or 16,
        start_idx=int(get("start_idx") or 0),
        height=get("height"),
        width=get("width"),
        resolution=int(res) if res else None,
        aspect_ratio=float(get("aspect_ratio") or 1.81),
        vae_path=gp("extra_model.vae.params_path") or get("vae_path"),
        clip_path=(gp("extra_model.image_encoder.params_path")
                   or get("image_encoder_path")),
        t5_path=(gp("extra_model.text_encoder.params_path")
                 or get("text_encoder_path") or ""),
        tokenizer=(gp("extra_model.text_encoder.tokenizer")
                   or get("tokenizer_path") or "google/umt5-xxl"),
        text_len=int(gp("extra_model.text_encoder.t5_text_len")
                     or get("max_sequence_length") or 512),
    )


def load_vae(path: str, device) -> vae_mod.WanVAE:
    refuse_orbax(path, "the VAE weights")
    return encoders.load_reference_vae(path, device)


def load_clip(path: str, device) -> clip_mod.CLIPVisionTower:
    refuse_orbax(path, "the CLIP weights")
    return encoders.load_reference_clip_visual(path, device)


def clip_size(c, frames: np.ndarray):
    """(height, width) of a clip: the reference's per-clip sizing where the
    config gives a resolution, else the fixed height/width."""
    if c["resolution"]:
        return target_size_for(frames.shape[1], frames.shape[2], c["resolution"],
                               c["aspect_ratio"])
    return int(c["height"] or 480), int(c["width"] or 832)


def process_clip(c, clip_data, lat_dir, vae, clip, embed):
    """One clip's files and its manifest record; returns (record, the
    seconds of each part)."""
    base = clip_data["source_id"]
    t0 = time.perf_counter()
    frames, _ = read_video(clip_data["video_path"], num_frames=c["num_frames"],
                           target_fps=c["fps"], start_frame=c["start_idx"])
    video = to_model_range(resize_center_crop(frames, *clip_size(c, frames)))
    times = {"read_resize_s": time.perf_counter() - t0}
    latents, f1_lat, img_clip = encode_clip_data(vae, clip, video, times=times)
    paths = {
        "vae_latent_path": os.path.join(lat_dir, f"{base}.npy"),
        "f1_black_path": os.path.join(lat_dir, f"{base}_f1_black.npy"),
        "imgclip_path": os.path.join(lat_dir, f"{base}_img_clip.npy"),
        "textshort_path": os.path.join(lat_dir, f"{base}_textshort.npy"),
        "textlong_path": os.path.join(lat_dir, f"{base}_textlong.npy"),
    }
    np.save(paths["vae_latent_path"], latents)
    np.save(paths["f1_black_path"], f1_lat)
    np.save(paths["imgclip_path"], img_clip)
    t0 = time.perf_counter()
    if embed is not None:
        short = clip_data.get("short_caption", "")
        np.save(paths["textshort_path"], embed(short))
        np.save(paths["textlong_path"], embed(clip_data.get("long_caption", short)))
    else:
        del paths["textshort_path"], paths["textlong_path"]
    times["t5_s"] = time.perf_counter() - t0
    meta = {**clip_data, **paths, "latent_shape": list(latents.shape)}
    return meta, times


def main(config, device="cuda", stats=None) -> int:
    """Preprocess every clip of the config's input list; ``stats``, where
    given, gets each processed clip's {source_id, seconds by part, total}."""
    logging.basicConfig(level=logging.INFO)
    device = check_device(device)
    c = resolve_config(config)
    lat_dir = os.path.join(c["save_dir"], "latents")
    meta_dir = os.path.join(c["save_dir"], "meta_v1")
    os.makedirs(lat_dir, exist_ok=True)
    os.makedirs(meta_dir, exist_ok=True)
    if not c["vae_path"] or not os.path.exists(c["vae_path"]):
        logging.error("VAE weights not found (extra_model.vae.params_path / vae_path): %s",
                      c["vae_path"])
        return 1
    vae = load_vae(c["vae_path"], device)
    clip = load_clip(c["clip_path"], device)
    # the captions are encoded in the same pass where umT5 is configured
    embed = make_t5_embedder(c["t5_path"], c["tokenizer"], c["text_len"], device)
    with open(c["input_json"]) as f:
        data = json.load(f)
    for clip_data in data:
        base = clip_data["source_id"]
        meta_path = os.path.join(meta_dir, f"{base}_meta_v1.json")
        if os.path.isfile(meta_path):
            logging.info("already processed: %s", meta_path)
            continue
        try:
            t0 = time.perf_counter()
            meta, times = process_clip(c, clip_data, lat_dir, vae, clip, embed)
            with open(meta_path, "w") as f:
                json.dump(meta, f, indent=2, ensure_ascii=False)
            times["total_s"] = time.perf_counter() - t0
            logging.info("processed %s %s: %s", base, meta["latent_shape"], times)
            if stats is not None:
                stats.append({"source_id": base, **times})
        except Exception as e:  # noqa: BLE001 -- a bad clip is passed over, as the reference does
            logging.exception("failed on %s: %s", base, e)
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    sys.exit(main(load_config(args.config), args.device))
