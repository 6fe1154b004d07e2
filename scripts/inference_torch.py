"""Video and image generation CLI for the PyTorch port (counterpart of
scripts/inference.py): t2v, t2i, i2v and flf2v, from prompts and images to
decoded frames.

Builds the DiT pipeline once and answers each request from it: batched-CFG
sampling on one GPU. Without --ckpt_dir the DiT gets random weights,
seeded, from the port's ``wan_dit.init_params`` (the JAX initialisers'
distributions).

    python3 scripts/inference_torch.py --task t2v-1.3B --size 832*480 \\
        --frame_num 21 --sample_steps 4 [--quant int8] [--quant_attn int8] \\
        [--sample_solver unipc|dpm++|euler] [--teacache_thresh 0.08] \\
        [--prompt "..." --t5_path models_t5_umt5-xxl-enc-bf16.pth \\
         --tokenizer google/umt5-xxl] [--vae_path Wan2.1_VAE.pth]
    python3 scripts/inference_torch.py --task t2i-14B --size 832*480 \\
        --lora_path style.safetensors --distill_lora_path distill.pt ...
    python3 scripts/inference_torch.py --task t2v-1.3B --prompt_file prompts.txt \\
        --save_folder out/ --transformer_path <out>/checkpoint-100 ...
    python3 scripts/inference_torch.py --task i2v-14B --size 832*480 \\
        --image first.png [--last_image last.png] --vae_path Wan2.1_VAE.pth \\
        --clip_path models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth

The weights: ``--transformer_path`` (a post-trained DiT in the reference
safetensors layout, as ``utils/checkpoint.save_reference_dir`` and the
port's PRFL trainer write it) replaces ``--ckpt_dir``'s; an orbax
directory of the JAX package is refused. Then ``--lora_path`` and
``--distill_lora_path`` (``.safetensors`` files or directories, ``.pt``/
``.pth`` state dicts or ``.npz``, in the transformer, kohya or diffusers
key format) merge into the attention weights at ``--lora_scale`` and
``--distill_lora_alpha``, in that order, before any int8 quantization.

The requests: ``--prompt_file`` (a txt file of prompts, or a JSON list of
records with a prompt and, for i2v, an ``image_path``) gives one request
per record, with the seed ``--base_seed + index`` and the output
``<stem>_<index>`` beside ``--save_file``; otherwise one request from
``--prompt``/``--image``. ``--save_folder`` puts the outputs there.

The text: each prompt (and ``--negative_prompt``, the reference's default
otherwise) through the tokenizer (``--tokenizer``: tokenizer files, as
the JAX CLI needs; ``transformers`` loads them) and umT5-XXL
(``--t5_path``, a reference ``.pth``), each context trimmed to its tokens
and zero-padded to 512, as the reference DiT pads it; without
``--t5_path``, cached ``--prompt_embeds`` / ``--uncond_embeds`` (.npy
[1, L, 4096]) for every request; else zeros, as in the JAX CLI. The text
tower is freed before the DiT is built.

i2v and flf2v: ``--image`` (and ``--last_image`` for flf2v), or a
record's ``image_path``, load with PIL, resized bicubic to the latent
grid's pixels, then ``Conditioner.condition`` runs the CLIP tower
(``--clip_path``) on the frame(s) and the VAE's streaming encode on
[image, zeros..., (last image)]. Without an image they take cached
inputs: ``--clip_embeds`` (.npy CLIP features [257, 1280] or [n, 257,
1280]) and ``--cond_latent`` (.npy VAE latent of the conditioning frames,
[F, H, W, 16]), zeros when not given: [1, 257, 1280] CLIP features for
i2v, [2, 257, 1280] for flf2v (the shape its pipeline takes; the JAX
CLI's [1, 257, 1280] default cannot run flf2v). Sampling defaults follow
the JAX CLI: 40 steps when the task names i2v, else 50; shift 3.0 for i2v
at a 480 size, else 5.0; t2i-14B makes one frame.

The solver: ``--sample_solver`` unipc (default), dpm++ or euler.
``--teacache_thresh`` (t2v and t2i; ignored with a warning for i2v and
flf2v, as in the JAX CLI) skips the block stack on steps whose time
embedding changed little, with the reference's fitted coefficients
(``t2v-1.3b`` when the task names 1.3, else ``t2v-14b``); TeaCache always
samples with UniPC.

With ``--vae_path`` (a reference VAE ``.pth``) the latents are decoded,
streamed one latent frame at a time above 5 (``--decode_chunk``: -1 that
rule, 0 the whole clip, n frames a step), and written as mp4 where imageio
or OpenCV can (one frame: a PNG), else as uint8 ``<stem>_frames.npy``
[T, H, W, 3]; without it the latents go to ``<stem>_latents.npy``.

``--quant int8`` serves the block matmuls as W8A8 int8 GEMMs, the
weights quantized once after they load and merge; ``--quant_attn int8``
runs the self-attention's q k^T on the int8 path (kernel K10) wherever
its keys stream in several blocks. Either flag works alone.
``--offload_model``, ``--t5_fsdp``, ``--t5_cpu`` and ``--dit_fsdp`` are
accepted and do nothing, as in the JAX CLI. Not ported yet: multi-GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import random
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hyvideo_prfl_torch.configs import (  # noqa: E402
    MAX_AREA_CONFIGS, SAMPLE_NEG_PROMPT, SIZE_CONFIGS, dit_config_for_task,
)
from hyvideo_prfl_torch.data.dataset import EvalPromptDataset  # noqa: E402
from hyvideo_prfl_torch.models import clip as clip_mod  # noqa: E402
from hyvideo_prfl_torch.models import vae as vae_mod  # noqa: E402
from hyvideo_prfl_torch.models import wan_dit  # noqa: E402
from hyvideo_prfl_torch.pipelines.pipeline import (  # noqa: E402
    GenerateConfig, WanFLF2V, WanI2V, WanT2V, latent_size_for,
)
from hyvideo_prfl_torch.training import lora as lora_mod  # noqa: E402
from hyvideo_prfl_torch.utils import checkpoint as ck  # noqa: E402
from hyvideo_prfl_torch.utils import encoders, safetensors_io, video_io  # noqa: E402
from hyvideo_prfl_torch.utils.tokenizers import HuggingfaceTokenizer  # noqa: E402

TASKS = ("t2v", "t2i", "i2v", "flf2v")


def args_init(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="t2v-1.3B")
    p.add_argument("--size", default="480*832")
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--ckpt_dir", default=None,
                   help="reference Wan checkpoint dir (*.safetensors)")
    p.add_argument("--transformer_path", default=None,
                   help="post-trained DiT checkpoint dir (reference safetensors layout) "
                        "loaded instead of --ckpt_dir's")
    p.add_argument("--lora_path", default=None,
                   help="LoRA (.safetensors file or dir, .pt/.pth, .npz; transformer, "
                        "kohya or diffusers keys) merged into the DiT at load")
    p.add_argument("--lora_scale", "--lora_alpha", type=float, default=1.0, dest="lora_scale",
                   help="merge scale for --lora_path")
    p.add_argument("--distill_lora_path", default=None,
                   help="a second LoRA, merged after --lora_path")
    p.add_argument("--distill_lora_alpha", type=float, default=1.0)
    p.add_argument("--prompt", default=None, help="the text, through umT5-XXL")
    p.add_argument("--prompt_file", default=None,
                   help="txt (one prompt a line) or JSON list of {prompt, image_path?} "
                        "records; one output per record")
    p.add_argument("--negative_prompt", default=None,
                   help="the unconditional text (default: the reference's)")
    p.add_argument("--t5_path", default=None,
                   help="reference umT5-XXL encoder .pth (models_t5_umt5-xxl-enc-bf16.pth)")
    p.add_argument("--tokenizer", default="google/umt5-xxl")
    p.add_argument("--prompt_embeds", default=None,
                   help=".npy [1, L, 4096] cached T5 embedding")
    p.add_argument("--uncond_embeds", default=None)
    p.add_argument("--image", default=None, help="i2v/flf2v: the first frame (PIL)")
    p.add_argument("--last_image", default=None, help="flf2v: the last frame")
    p.add_argument("--clip_path", default=None,
                   help="reference whole-CLIP .pth (its visual.* keys) for --image")
    p.add_argument("--vae_path", default=None,
                   help="reference VAE .pth (Wan2.1_VAE.pth): decode the latents to "
                        "frames; --image needs it for the conditioning latent")
    p.add_argument("--decode_chunk", type=int, default=-1,
                   help="latent frames per decode step; -1: one above 5 latent frames, "
                        "else the whole clip; 0: the whole clip")
    p.add_argument("--clip_embeds", default=None,
                   help="i2v/flf2v: .npy CLIP image features [n, 257, 1280]")
    p.add_argument("--cond_latent", default=None,
                   help="i2v/flf2v: .npy conditioning latent [F, H, W, 16]")
    p.add_argument("--sample_solver", default="unipc", choices=("unipc", "euler", "dpm++"))
    p.add_argument("--sample_steps", type=int, default=None)
    p.add_argument("--sample_shift", type=float, default=None)
    p.add_argument("--sample_guide_scale", type=float, default=5.0)
    p.add_argument("--base_seed", type=int, default=42)
    p.add_argument("--teacache_thresh", type=float, default=None,
                   help="t2v/t2i: skip the block stack while the time embedding changes "
                        "little (TeaCache; samples with UniPC)")
    p.add_argument("--quant", choices=("none", "int8"), default="none",
                   help="serve the DiT block matmuls as W8A8 int8 GEMMs")
    p.add_argument("--quant_attn", choices=("none", "int8"), default="none",
                   help="run the self-attention q k^T on the int8 path (K10)")
    p.add_argument("--save_file", default="out.mp4")
    p.add_argument("--save_folder", default=None,
                   help="directory for the outputs; --save_file's name goes there")
    p.add_argument("--device", default="cuda")
    # accepted for the reference CLI's sake; one GPU holds the whole model
    p.add_argument("--offload_model", default=None)
    p.add_argument("--t5_fsdp", action="store_true")
    p.add_argument("--t5_cpu", action="store_true")
    p.add_argument("--dit_fsdp", action="store_true")
    args = p.parse_args(argv)
    if not any(kind in args.task for kind in TASKS):
        p.error(f"task {args.task}: only t2v, t2i, i2v and flf2v are ported")
    if "t2i" in args.task:
        if args.frame_num == p.get_default("frame_num"):
            args.frame_num = 1
        if args.frame_num != 1:
            p.error(f"task {args.task} makes one frame, not --frame_num {args.frame_num}")
    if args.sample_steps is None:
        args.sample_steps = 40 if "i2v" in args.task else 50
    if args.sample_shift is None:
        args.sample_shift = 3.0 if ("i2v" in args.task and "480" in args.size) else 5.0
    if args.base_seed < 0:
        args.base_seed = random.randint(0, 2**31 - 1)
    if args.prompt is not None and not args.t5_path:
        p.error("--prompt needs --t5_path (a reference umT5-XXL encoder .pth)")
    if args.image and not (args.vae_path and args.clip_path):
        p.error("--image needs --vae_path and --clip_path")
    if args.last_image and "flf2v" not in args.task:
        p.error("--last_image is flf2v's")
    if "flf2v" in args.task and bool(args.image) != bool(args.last_image):
        p.error("flf2v: --image and --last_image go together")
    if args.teacache_thresh is not None and pipeline_class(args.task) is not WanT2V:
        logging.warning("--teacache_thresh is for t2v and t2i; ignored for %s", args.task)
        args.teacache_thresh = None
    if args.teacache_thresh is not None and args.sample_solver != "unipc":
        logging.warning("TeaCache samples with UniPC; --sample_solver %s is not used",
                        args.sample_solver)
    if args.save_folder:
        os.makedirs(args.save_folder, exist_ok=True)
        args.save_file = os.path.join(args.save_folder, os.path.basename(args.save_file))
    if args.offload_model or args.t5_fsdp or args.t5_cpu or args.dit_fsdp:
        logging.info("offload/fsdp flags accepted for CLI compatibility: one GPU holds "
                     "each model whole")
    return args


def teacache_key(task: str) -> str:
    """The TeaCache coefficients of a t2v/t2i task (the JAX CLI's rule)."""
    return "t2v-1.3b" if "1.3" in task.lower() else "t2v-14b"


@dataclasses.dataclass
class Request:
    """One generation: its seed, text contexts, sampling settings and, for
    i2v/flf2v, its image conditioning."""

    seed: int
    context: torch.Tensor       # [1, text_len, text_dim]
    context_null: torch.Tensor  # [1, text_len, text_dim]
    frame_num: int
    sample_steps: int
    sample_shift: float = 5.0
    guide_scale: float = 5.0
    clip_fea: Optional[torch.Tensor] = None     # [1 or 2, 257, 1280]
    cond_latent: Optional[torch.Tensor] = None  # [1, F, H, W, 16]
    sample_solver: str = "unipc"
    teacache_thresh: Optional[float] = None     # t2v/t2i: sample with TeaCache
    teacache_key: str = "t2v-14b"


def pipeline_class(task: str):
    if "flf2v" in task:
        return WanFLF2V
    return WanI2V if "i2v" in task else WanT2V


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a .safetensors file or directory, a .pt/.pth
    file or a .npz."""
    if os.path.isdir(path):
        return safetensors_io.load_dir(path)
    if path.endswith(".safetensors"):
        return safetensors_io.read_file(path)
    if path.endswith((".pt", ".pth")):
        return torch.load(path, map_location="cpu", weights_only=True)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    raise SystemExit(f"{path}: not a .safetensors file or directory, .pt/.pth or .npz")


def load_transformer(path: str, cfg) -> Dict[str, torch.Tensor]:
    """--transformer_path: a reference safetensors directory -> the port's
    state dict. The JAX package's orbax directories are refused."""
    if not os.path.isdir(path):
        raise SystemExit(f"--transformer_path {path} is not a directory")
    if not any(f.endswith(".safetensors") for f in os.listdir(path)):
        raise SystemExit(
            f"--transformer_path {path} holds no .safetensors: an orbax checkpoint of the "
            "JAX package? The port reads reference safetensors directories (the JAX "
            "package's save_wan_checkpoint and the port's save_reference_dir write them)")
    return ck.load_reference_dir(path, cfg)


def load_dit(args, cfg, device) -> wan_dit.WanModel:
    """The float DiT on ``device``: --transformer_path, else --ckpt_dir,
    else seeded random weights."""
    model = wan_dit.WanModel(cfg, device=device)
    if args.transformer_path:
        model.load_state_dict(load_transformer(args.transformer_path, cfg))
        logging.info("loaded the transformer from %s", args.transformer_path)
    elif args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        model.load_state_dict(ck.load_reference_dir(args.ckpt_dir, cfg))
    else:
        logging.warning("no --ckpt_dir; random weights")
        wan_dit.init_params(model, torch.Generator(device=device).manual_seed(0))
    return model


def build_pipeline(args) -> WanT2V:
    """The DiT on args.device (``load_dit``), each LoRA merged, then
    quantized under --quant int8."""
    device = check_device(torch.device(args.device))
    cfg = dit_config_for_task(args.task, quant_attn=None if args.quant_attn == "none"
                              else args.quant_attn)
    model = load_dit(args, cfg, device)
    for path, scale in ((args.lora_path, args.lora_scale),
                        (args.distill_lora_path, args.distill_lora_alpha)):
        if path:
            lora = lora_mod.lora_from_state_dict(read_state_dict(path), head_dim=cfg.head_dim)
            lora_mod.merge_lora(model, lora, scale)
            n = sum(len(mods) for mods in lora["lora"].values())
            logging.info("merged the LoRA %s (%d modules, scale %.2f)", path, n, scale)
    if args.quant == "int8":
        model = ck.quantize_model(model)
        logging.info("quantized the block matmuls to int8 (W8A8)")
    return pipeline_class(args.task)(model.eval())


def check_device(device: torch.device) -> torch.device:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    return device


class TextEncoder:
    """Tokenizer + umT5: ``self(texts)`` -> contexts [n, text_len, dim]
    fp32 on the encoder's device, each trimmed to its tokens and
    zero-padded to text_len, as the reference DiT pads its context."""

    def __init__(self, t5, tokenizer, text_len: int = 512):
        self.t5, self.tokenizer, self.text_len = t5, tokenizer, text_len

    def __call__(self, texts):
        ids, mask = self.tokenizer(list(texts), return_mask=True)
        dev = self.t5.token_embedding.weight.device
        out = self.t5(torch.as_tensor(np.asarray(ids), device=dev).long(),
                      torch.as_tensor(np.asarray(mask), device=dev))
        ctx = out.new_zeros((out.shape[0], self.text_len, out.shape[2]))
        for i, n in enumerate(np.asarray(mask).sum(axis=1)):
            n = min(int(n), self.text_len)
            ctx[i, :n] = out[i, :n]
        return ctx


def make_text_encoder(args, device) -> TextEncoder:
    return TextEncoder(encoders.load_reference_t5(args.t5_path, device),
                       HuggingfaceTokenizer(args.tokenizer, seq_len=512, clean="whitespace"))


class Conditioner:
    """i2v/flf2v image conditioning: the CLIP tower on the first (and
    last) frame and the VAE's streaming encode of [first, zeros...,
    (last)]."""

    def __init__(self, clip: clip_mod.CLIPVisionTower, vae: vae_mod.WanVAE):
        self.clip, self.vae = clip, vae

    def pixels(self, lat_f: int, lat_h: int, lat_w: int):
        """(frames, height, width) of the pixel video behind a latent grid."""
        t, s, _ = self.vae.cfg.stride
        return (lat_f - 1) * t + 1, lat_h * s, lat_w * s

    def condition(self, frames: torch.Tensor, lat_f: int):
        """frames [n, H, W, 3] in [-1, 1] (n = 2: first and last) -> (CLIP
        features [n, tokens, dim], conditioning latent [1, lat_f, H/8,
        W/8, z]), on the VAE's device."""
        dev = self.vae.conv1.weight.device
        frames = frames.to(dev, torch.float32)
        clip_fea = self.clip(clip_mod.preprocess_frames(frames, self.clip.cfg.image_size))
        f_pix = self.pixels(lat_f, 1, 1)[0]
        vid = frames.new_zeros((1, f_pix, *frames.shape[1:]))
        vid[0, 0] = frames[0]
        if frames.shape[0] > 1:
            vid[0, -1] = frames[1]
        return clip_fea, vae_mod.encode_streaming(self.vae, vid)


def load_image(path: str, height: int, width: int) -> np.ndarray:
    """An image file -> [H, W, 3] fp32 in [-1, 1], resized bicubic (PIL)."""
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit("--image needs PIL, which is not installed here; give "
                         "--clip_embeds and --cond_latent instead") from None
    img = Image.open(path).convert("RGB").resize((width, height), Image.BICUBIC)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def write_frames(video: torch.Tensor, save_file: str) -> str:
    """Decoded [T, H, W, 3] in [-1, 1] -> an image for one frame, else a
    video (mp4, or uint8 ``_frames.npy`` without a writer)."""
    if video.shape[0] == 1:
        return video_io.cache_image(video[0], os.path.splitext(save_file)[0] + ".png")
    return video_io.cache_video(video, save_file)


def load_or_zeros(path, shape, device) -> torch.Tensor:
    if path and os.path.exists(path):
        a = np.load(path)
        return torch.from_numpy(a if a.ndim == 3 else a[None]).float().to(device)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def latent_grid(size: str, frame_num: int):
    w, h = SIZE_CONFIGS[size]
    return latent_size_for(MAX_AREA_CONFIGS.get(size, w * h), h / w,
                           num_frames=frame_num)


def clip_shape(task: str):
    """The zero CLIP features' shape when --clip_embeds is not given."""
    return (2 if "flf2v" in task else 1, 257, 1280)


def read_records(args) -> List[Dict]:
    """The requests' records: --prompt_file's (prompt, image_path), or the
    one from --prompt/--image/--last_image."""
    if args.prompt_file:
        return [{"prompt": it.get("prompt", ""), "image_path": it.get("image_path")}
                for it in EvalPromptDataset(args.prompt_file).items]
    return [{"prompt": args.prompt, "image_path": args.image,
             "last_image_path": args.last_image}]


def text_contexts(args, records, cfg, device):
    """-> (one context [1, text_len, text_dim] per record, the negative
    context). With --prompt or --prompt_file and --t5_path, each prompt and
    the negative prompt go through the text encoder alone (a text's
    context does not depend on the others'), which is then freed; a record
    without a prompt, or every record without --t5_path, takes
    --prompt_embeds."""
    shape = (1, cfg.text_len, cfg.text_dim)
    cached = load_or_zeros(args.prompt_embeds, shape, device)
    if not (args.t5_path and (args.prompt is not None or args.prompt_file)):
        return [cached] * len(records), load_or_zeros(args.uncond_embeds, shape, device)
    neg = args.negative_prompt if args.negative_prompt is not None else SAMPLE_NEG_PROMPT
    text = make_text_encoder(args, device)
    contexts = [text([r["prompt"]]) if r.get("prompt") else cached for r in records]
    context_null = text([neg])
    del text
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return contexts, context_null


def image_conditions(args, records, vae, grid, device) -> List[Dict]:
    """i2v/flf2v: each record's clip_fea and cond_latent, from its image
    (and --last_image) through ``Conditioner``, else from --clip_embeds and
    --cond_latent (zeros when not given). t2v/t2i: none."""
    if pipeline_class(args.task) is WanT2V:
        return [{} for _ in records]
    lat_f, lat_h, lat_w = grid
    cond = None
    if any(r.get("image_path") for r in records):
        if not (vae is not None and args.clip_path):
            raise SystemExit("an image record needs --vae_path and --clip_path")
        cond = Conditioner(encoders.load_reference_clip_visual(args.clip_path, device), vae)
    out = []
    for r in records:
        if not r.get("image_path"):
            out.append(dict(
                clip_fea=load_or_zeros(args.clip_embeds, clip_shape(args.task), device),
                cond_latent=load_or_zeros(args.cond_latent, (1, lat_f, lat_h, lat_w, 16),
                                          device)))
            continue
        paths = [r["image_path"]] + ([r["last_image_path"]] if r.get("last_image_path") else [])
        if "flf2v" in args.task and len(paths) != 2:
            raise SystemExit(f"flf2v: record {r} has no last image")
        _, h, w = cond.pixels(lat_f, lat_h, lat_w)
        frames = torch.from_numpy(np.stack([load_image(p, h, w) for p in paths]))
        clip_fea, cond_latent = cond.condition(frames, lat_f)
        out.append(dict(clip_fea=clip_fea, cond_latent=cond_latent))
    return out


def run_request(pipe: WanT2V, req: Request, size: str) -> torch.Tensor:
    """Latents [1, F, H, W, 16] fp32 for one request."""
    lat_f, lat_h, lat_w = latent_grid(size, req.frame_num)
    gen = GenerateConfig(sampling_steps=req.sample_steps, shift=req.sample_shift,
                         guide_scale=req.guide_scale, sample_solver=req.sample_solver)
    g = torch.Generator(device=req.context.device).manual_seed(req.seed)
    if isinstance(pipe, WanI2V):
        want = (1, lat_f, lat_h, lat_w, 16)
        if tuple(req.cond_latent.shape) != want:
            raise ValueError(f"cond_latent {tuple(req.cond_latent.shape)}, expected {want}")
        return pipe.generate(g, req.context, req.context_null, req.clip_fea,
                             req.cond_latent, gen)
    if req.teacache_thresh is not None:
        shape = (1, lat_f, lat_h, lat_w, pipe.cfg.out_dim)
        lat = pipe.sample_teacache(g, shape, req.context, req.context_null, gen,
                                   thresh=req.teacache_thresh, coeffs_key=req.teacache_key)
        skipped = [i for i, s in enumerate(pipe.teacache_skips) if s]
        logging.info("TeaCache (UniPC, %s coefficients, threshold %g): computed %d of %d "
                     "steps, skipped %s", req.teacache_key, req.teacache_thresh,
                     req.sample_steps - len(skipped), req.sample_steps, skipped)
        return lat
    return pipe.generate(g, req.context, req.context_null, lat_f, lat_h, lat_w, gen)


def output_file(save_file: str, idx: int, n: int) -> str:
    """The output of record ``idx`` of ``n``: --save_file itself for one
    record, else ``<stem>_<idx:03d><ext>``."""
    if n == 1:
        return save_file
    stem, ext = os.path.splitext(save_file)
    return f"{stem}_{idx:03d}{ext}"


def main(argv=None):
    args = args_init(argv)
    logging.basicConfig(level=logging.INFO)
    device = check_device(torch.device(args.device))
    torch.backends.cudnn.allow_tf32 = False  # the towers' fp32 convolutions, not TF32
    cfg = dit_config_for_task(args.task)
    grid = latent_grid(args.size, args.frame_num)
    records = read_records(args)
    # the text tower first, freed before the DiT is built
    contexts, context_null = text_contexts(args, records, cfg, device)
    vae = encoders.load_reference_vae(args.vae_path, device) if args.vae_path else None
    images = image_conditions(args, records, vae, grid, device)
    pipe = build_pipeline(args)
    latents = []
    for idx, (rec, context, image) in enumerate(zip(records, contexts, images)):
        req = Request(
            seed=args.base_seed + idx, context=context, context_null=context_null,
            frame_num=args.frame_num, sample_steps=args.sample_steps,
            sample_shift=args.sample_shift, guide_scale=args.sample_guide_scale,
            sample_solver=args.sample_solver, teacache_thresh=args.teacache_thresh,
            teacache_key=teacache_key(args.task), **image)
        latents.append(run_request(pipe, req, args.size))
        logging.info("record %d/%d (seed %d) latents %s", idx + 1, len(records), req.seed,
                     tuple(latents[-1].shape))
    del pipe, images
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for idx, lat in enumerate(latents):
        save_file = output_file(args.save_file, idx, len(latents))
        if vae is None:
            stem = os.path.splitext(save_file)[0]
            np.save(stem + "_latents.npy", lat.cpu().numpy())
            logging.info("latents %s -> %s_latents.npy (no --vae_path)", tuple(lat.shape),
                         stem)
            continue
        written = write_frames(vae_mod.decode(vae, lat, args.decode_chunk)[0], save_file)
        logging.info("latents %s decoded -> %s", tuple(lat.shape), written)
    return 0


if __name__ == "__main__":
    sys.exit(main())
