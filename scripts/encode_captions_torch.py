"""Captions -> umT5-XXL embeddings for the latent cache, on the card
(the port's counterpart of scripts/encode_captions.py).

Fills in the manifests ``scripts/gen_latents_torch.py`` wrote without text
embeddings: each ``*_meta_v1.json`` without an existing ``textshort_path``
gets ``{id}_textshort.npy`` and ``{id}_textlong.npy`` ([1, n, 4096] fp32,
the caption's n tokens) beside its latents, and its JSON rewritten; with
``--null_dir`` also ``wanx/null.npy`` (the empty prompt) and
``wanx/uncond.npy`` (``--negative_prompt``), which the trainers read.

    python3 scripts/encode_captions_torch.py --meta_dir latent_cache/meta_v1 \
        --t5_params weights/models_t5_umt5-xxl-enc-bf16.pth \
        --tokenizer weights/google/umt5-xxl [--null_dir temp_data/null]

The weights are the reference ``.pth`` file (bf16, as released); an orbax
directory of the JAX package is refused. ``--device cuda`` by default.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hyvideo_prfl_torch.utils import encoders  # noqa: E402
from hyvideo_prfl_torch.utils.tokenizers import HuggingfaceTokenizer  # noqa: E402


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass --device cpu)")
    return device


def refuse_orbax(path: str, flag: str) -> None:
    """The JAX package also reads its own orbax directories; the port reads
    the reference ``.pth`` files."""
    if os.path.isdir(path):
        raise SystemExit(
            f"{flag} {path} is a directory: an orbax checkpoint of the JAX package? The port "
            "reads the reference .pth files (Wan2.1_VAE.pth, the whole-CLIP .pth, "
            "models_t5_umt5-xxl-enc-bf16.pth)")


class T5Embedder:
    """``self(text)`` -> [1, n, dim] fp32 on the host: umT5 on the text's
    tokens, trimmed to them (at least one row)."""

    def __init__(self, t5, tokenizer):
        self.t5, self.tokenizer = t5, tokenizer

    def __call__(self, text: str) -> np.ndarray:
        ids, mask = self.tokenizer([text], return_mask=True)
        dev = self.t5.token_embedding.weight.device
        out = self.t5(torch.as_tensor(np.asarray(ids), device=dev).long(),
                      torch.as_tensor(np.asarray(mask), device=dev))
        n = int(np.asarray(mask).sum())
        return out[:, :max(n, 1)].float().cpu().numpy()


def make_t5_embedder(t5_path: str, tokenizer: str = "google/umt5-xxl", text_len: int = 512,
                     device="cpu"):
    """A ``T5Embedder`` over the reference umT5 file at ``t5_path``, or None
    where the file or the tokenizer's files are absent."""
    if not t5_path or not os.path.exists(t5_path):
        return None
    refuse_orbax(t5_path, "the T5 weights")
    try:
        tok = HuggingfaceTokenizer(tokenizer, seq_len=text_len, clean="whitespace")
    except Exception as e:  # noqa: BLE001 -- the tokenizer's files are absent
        logging.error("tokenizer %s unavailable: %s", tokenizer, e)
        return None
    return T5Embedder(encoders.load_reference_t5(t5_path, device), tok)


def encode_manifests(embed, meta_dir: str) -> int:
    """Text embeddings for each manifest in ``meta_dir`` that has none;
    returns how many were encoded."""
    n = 0
    for fname in sorted(os.listdir(meta_dir)):
        if not fname.endswith("_meta_v1.json"):
            continue
        path = os.path.join(meta_dir, fname)
        with open(path) as f:
            meta = json.load(f)
        if "textshort_path" in meta and os.path.exists(meta["textshort_path"]):
            continue
        base = meta.get("source_id", fname.replace("_meta_v1.json", ""))
        lat_dir = os.path.dirname(meta.get("vae_latent_path", path))
        short_p = os.path.join(lat_dir, f"{base}_textshort.npy")
        long_p = os.path.join(lat_dir, f"{base}_textlong.npy")
        np.save(short_p, embed(meta.get("short_caption", "")))
        np.save(long_p, embed(meta.get("long_caption", meta.get("short_caption", ""))))
        meta["textshort_path"] = short_p
        meta["textlong_path"] = long_p
        with open(path, "w") as f:
            json.dump(meta, f, indent=2, ensure_ascii=False)
        logging.info("encoded %s", base)
        n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--meta_dir", required=True, help="the *_meta_v1.json manifests to fill in")
    p.add_argument("--t5_params", required=True, help="the reference umT5-XXL .pth file")
    p.add_argument("--tokenizer", default="google/umt5-xxl")
    p.add_argument("--text_len", type=int, default=512)
    p.add_argument("--null_dir", default=None, help="also write null/uncond embeddings here")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = check_device(args.device)
    embed = make_t5_embedder(args.t5_params, args.tokenizer, args.text_len, device)
    if embed is None:
        logging.error("T5 weights or tokenizer not found at %s / %s", args.t5_params,
                      args.tokenizer)
        return 1
    if args.null_dir:
        os.makedirs(os.path.join(args.null_dir, "wanx"), exist_ok=True)
        np.save(os.path.join(args.null_dir, "wanx", "null.npy"), embed(""))
        np.save(os.path.join(args.null_dir, "wanx", "uncond.npy"), embed(args.negative_prompt))
        logging.info("wrote null/uncond embeddings to %s", args.null_dir)
    encode_manifests(embed, args.meta_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
