"""Causal 3D video VAE of Wan2.1 (hyvideo_prfl_tpu/models/vae.py).

Plain PyTorch: the JAX package leaves the VAE's convolutions, products and
softmax to XLA (no Pallas kernel runs in it), so here they are cuDNN's and
cuBLAS's through ``F.conv3d`` and ``torch.matmul``.

The modules are named as the reference ``WanVAE_`` state dict
(``encoder.downsamples.{i}.residual.{0,2,3,6}``, ``...resample.1``,
``...time_conv``, ``middle.{0,1,2}``, ``head.{0,2}``, top-level ``conv1``
and ``conv2``), so a reference file loads with ``load_state_dict``
(``utils/encoders.load_reference_vae``). Activations run channels-first
[B, C, T, H, W]; ``encode``/``decode`` take and return the package's
channels-last [B, T, H, W, C] and convert only at those edges.

The network is the reference's feat-cache semantics, as the JAX package
writes them:

* every kt=3 conv is causal: two frames of left context in time, zeros at
  the start of the clip (in a stream, the last two input frames of the
  previous chunk);
* RMS norm is ``F.normalize`` over channels times sqrt(C) times gamma
  (clamp 1e-12), in fp32;
* Downsample: zero pad (0, 1, 0, 1), a stride-2 VALID 3x3 conv per frame;
  with a time conv, frame 0 passes unconvolved and a k3 stride-2 conv
  covers the windows (t-2, t-1, t) at t = 2, 4, ...;
* Upsample: with a time conv, frame 0 is zero in the conv's input stream
  and bypasses it (one frame, not two); every later frame becomes two by
  the 2C-channel split-interleave; then nearest 2x and a 3x3 conv to C/2;
* the middle attention is single-head over a frame's h*w tokens, fp32
  logits, computed a few frames at a time to bound its memory;
* the latent mean/std scale applies only when z_dim is 16; ``decode``
  clamps to [-1, 1].

One code path serves the whole clip and the stream: the whole clip is the
stream's first chunk with no cache. ``encode_streaming`` feeds pixel frames
1, then 4 at a time; ``decode_streaming`` latent frames 1, then
``frames_per_chunk`` at a time, each conv carrying its last two input
frames (a 1-frame cache keeps the downsample's stride-2 phase), in fp32 or
bf16 (norms in fp32 either way; the output is clamped fp32), each chunk's
frames moved to the CPU as it completes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LATENT_MEAN = np.asarray([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
LATENT_STD = np.asarray([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)
CACHE_T = 2
ATTN_LOGIT_BYTES = 1 << 30  # fp32 logits held at once by the middle attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """The published Wan2.1 VAE by default: stride (4, 8, 8), 16 latent
    channels."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)

    @property
    def temporal_upsample(self):
        return tuple(reversed(self.temporal_downsample))

    @property
    def stride(self) -> Tuple[int, int, int]:
        s = 2 ** (len(self.dim_mult) - 1)
        return 2 ** sum(self.temporal_downsample), s, s


def tiny_vae(**kw) -> VAEConfig:
    kw.setdefault("dim", 16)
    kw.setdefault("z_dim", 4)
    kw.setdefault("dim_mult", (1, 2))
    kw.setdefault("num_res_blocks", 1)
    kw.setdefault("temporal_downsample", (True,))
    return VAEConfig(**kw)


def infer_config(state: Dict) -> VAEConfig:
    """The VAEConfig of a reference-layout state dict, from its keys and
    shapes: dim from encoder.conv1, z_dim from conv2, the stages from the
    encoder's resample entries, the blocks per stage, each stage's width
    from its first block, a temporal downsample where a time_conv is."""
    dim = int(state["encoder.conv1.weight"].shape[0])
    z_dim = int(state["conv2.weight"].shape[0])
    idx = sorted({int(k.split(".")[2]) for k in state if k.startswith("encoder.downsamples.")})
    resample = [i for i in idx if f"encoder.downsamples.{i}.resample.1.weight" in state]
    stages = len(resample) + 1
    nrb = (len(idx) - len(resample)) // stages
    mult = tuple(int(state[f"encoder.downsamples.{s * (nrb + 1)}.residual.2.weight"].shape[0])
                 // dim for s in range(stages))
    tdown = tuple(f"encoder.downsamples.{i}.time_conv.weight" in state for i in resample)
    return VAEConfig(dim=dim, z_dim=z_dim, dim_mult=mult, num_res_blocks=nrb,
                     temporal_downsample=tdown)


def _scale(z_dim: int, device):
    if z_dim == 16:
        mean, std = LATENT_MEAN, LATENT_STD
    else:
        mean, std = np.zeros(z_dim, np.float32), np.ones(z_dim, np.float32)
    return (torch.from_numpy(mean).to(device).view(1, -1, 1, 1, 1),
            torch.from_numpy(std).to(device).view(1, -1, 1, 1, 1))


def _conv(conv: nn.Module, x, stride=1, padding=0):
    """A Conv3d (or a Conv2d applied per frame) in x's dtype."""
    w = conv.weight.to(x.dtype)
    if w.dim() == 4:
        w = w.unsqueeze(2)
    return F.conv3d(x, w, conv.bias.to(x.dtype), stride=stride, padding=padding)


Stream = Dict[nn.Module, torch.Tensor]  # each conv's last input frames, keyed by the conv


def _causal(conv: nn.Module, x, st: Optional[Stream]):
    """kt=3 causal conv: the cached last two input frames (zeros at the
    start) in front, VALID in time, SAME in space; kt=1 convs need none."""
    kt, kh, kw = conv.kernel_size
    if kt > 1:
        prev = st.get(conv) if st is not None else None
        if prev is None:
            prev = x.new_zeros((*x.shape[:2], kt - 1, *x.shape[3:]))
        x = torch.cat([prev, x], dim=2)
        if st is not None:
            st[conv] = x[:, :, -CACHE_T:]
    return _conv(conv, x, padding=(0, kh // 2, kw // 2))


class RMSNorm(nn.Module):
    """gamma shaped as the reference's: [C, 1, 1, 1] over video, [C, 1, 1]
    in the attention block."""

    def __init__(self, dim: int, video: bool = True, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones((dim, 1, 1, 1) if video else (dim, 1, 1),
                                             device=device))

    def forward(self, x):
        c = x.shape[1]
        xf = x.float()
        norm = torch.linalg.vector_norm(xf, dim=1, keepdim=True)
        y = xf / torch.clamp(norm, min=1e-12) * math.sqrt(c)
        return (y * self.gamma.float().view(1, c, 1, 1, 1)).to(x.dtype)


def _conv3(cin, cout, device, kernel=3, stride=1):
    return nn.Conv3d(cin, cout, kernel, stride=stride, device=device)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.residual = nn.ModuleList([
            RMSNorm(cin, device=device), nn.SiLU(), _conv3(cin, cout, device),
            RMSNorm(cout, device=device), nn.SiLU(), nn.Dropout(0.0),
            _conv3(cout, cout, device)])
        self.shortcut = _conv3(cin, cout, device, kernel=1) if cin != cout else None

    def forward(self, x, st):
        r = self.residual
        h = _causal(r[2], F.silu(r[0](x)), st)
        h = _causal(r[6], F.silu(r[3](h)), st)
        if self.shortcut is not None:
            x = _conv(self.shortcut, x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-head attention over each frame's h*w tokens."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = RMSNorm(dim, video=False, device=device)
        self.to_qkv = nn.Conv2d(dim, dim * 3, 1, device=device)
        self.proj = nn.Conv2d(dim, dim, 1, device=device)

    def forward(self, x, st=None):
        b, c, t, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
        w_qkv = self.to_qkv.weight[:, :, 0, 0].to(x.dtype)
        w_o = self.proj.weight[:, :, 0, 0].to(x.dtype)
        per = max(1, ATTN_LOGIT_BYTES // (4 * (h * w) ** 2))
        outs = []
        for i in range(0, b * t, per):
            qkv = F.linear(y[i:i + per], w_qkv, self.to_qkv.bias.to(x.dtype))
            q, k, v = qkv.float().chunk(3, dim=-1)
            logits = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c)
            probs = torch.softmax(logits, dim=-1).to(x.dtype).float()
            o = torch.matmul(probs, v).to(x.dtype)
            outs.append(F.linear(o, w_o, self.proj.bias.to(x.dtype)))
        o = torch.cat(outs).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        return x + o


class Resample(nn.Module):
    """The reference's Resample: ``resample`` (a parameter-free pad or
    upsample, then a Conv2d) and, for the 3d modes, ``time_conv``."""

    def __init__(self, dim: int, up: bool, temporal: bool, device=None):
        super().__init__()
        self.up, self.temporal = up, temporal
        if up:
            self.resample = nn.ModuleList([nn.Identity(),
                                           nn.Conv2d(dim, dim // 2, 3, padding=1, device=device)])
            self.time_conv = (nn.Conv3d(dim, dim * 2, (3, 1, 1), device=device)
                              if temporal else None)
        else:
            self.resample = nn.ModuleList([nn.Identity(),
                                           nn.Conv2d(dim, dim, 3, stride=2, device=device)])
            self.time_conv = (nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), device=device)
                              if temporal else None)

    def forward(self, x, st, first: bool):
        return self._up(x, st, first) if self.up else self._down(x, st, first)

    def _down(self, x, st, first):
        xs = _conv(self.resample[1], F.pad(x, (0, 1, 0, 1)), stride=(1, 2, 2))
        if not self.temporal:
            return xs
        # frame 0 bypasses the time conv; a later chunk starts from the
        # cached last frame so the stride-2 windows keep their phase
        xin = xs if first else torch.cat([st[self.time_conv], xs], dim=2)
        if st is not None:
            st[self.time_conv] = xin[:, :, -1:]
        parts = [xs[:, :, :1]] if first else []
        if xin.shape[2] >= 3:
            parts.append(_conv(self.time_conv, xin, stride=(2, 1, 1)))
        return torch.cat(parts, dim=2)

    def _up(self, x, st, first):
        if self.temporal and (not first or x.shape[2] > 1):
            b, c, t, h, w = x.shape
            xin = torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, 1:]], dim=2) if first else x
            y = _causal(self.time_conv, xin, st)
            y = y.view(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)
            x = torch.cat([x[:, :, :1], y[:, :, 2:]], dim=2) if first else y
        # a first chunk of one frame leaves the time conv's cache unset: its
        # zero start is the zeroed frame 0 of the conv's stream
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return _conv(self.resample[1], x, padding=(0, 1, 1))


def _head(c: int, out: int, device):
    return nn.ModuleList([RMSNorm(c, device=device), nn.SiLU(), _conv3(c, out, device)])


def _middle(c: int, device):
    return nn.ModuleList([ResidualBlock(c, c, device), AttentionBlock(c, device),
                          ResidualBlock(c, c, device)])


def _run(layers, x, st, first):
    for layer in layers:
        x = layer(x, st, first) if isinstance(layer, Resample) else layer(x, st)
    return x


class Encoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = _conv3(3, dims[0], device)
        layers, c = [], dims[0]
        for i in range(len(cfg.dim_mult)):
            for _ in range(cfg.num_res_blocks):
                layers.append(ResidualBlock(c, dims[i + 1], device))
                c = dims[i + 1]
            if i != len(cfg.dim_mult) - 1:
                layers.append(Resample(c, False, cfg.temporal_downsample[i], device))
        self.downsamples = nn.ModuleList(layers)
        self.middle = _middle(c, device)
        self.head = _head(c, cfg.z_dim * 2, device)

    def forward(self, x, st, first):
        x = _causal(self.conv1, x, st)
        x = _run(self.middle, _run(self.downsamples, x, st, first), st, first)
        return _causal(self.head[2], F.silu(self.head[0](x)), st)


class Decoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        mult = tuple(cfg.dim_mult)
        dims = [cfg.dim * u for u in (mult[-1],) + tuple(reversed(mult))]
        c = dims[0]
        self.conv1 = _conv3(cfg.z_dim, c, device)
        self.middle = _middle(c, device)
        layers = []
        for i in range(len(mult)):
            for _ in range(cfg.num_res_blocks + 1):
                layers.append(ResidualBlock(c, dims[i + 1], device))
                c = dims[i + 1]
            if i != len(mult) - 1:
                layers.append(Resample(c, True, cfg.temporal_upsample[i], device))
                c //= 2
        self.upsamples = nn.ModuleList(layers)
        self.head = _head(c, 3, device)

    def forward(self, x, st, first):
        x = _causal(self.conv1, x, st)
        x = _run(self.upsamples, _run(self.middle, x, st, first), st, first)
        return _causal(self.head[2], F.silu(self.head[0](x)), st)


class WanVAE(nn.Module):
    """encode: video [B, T, H, W, 3] in [-1, 1] -> normalized latents
    [B, 1 + (T - 1) / 4, H / 8, W / 8, z_dim] fp32; decode: the inverse,
    clamped to [-1, 1]. Both whole-clip; the module-level
    ``encode_streaming``/``decode_streaming`` bound the memory."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder3d(cfg, device)
        self.conv1 = _conv3(cfg.z_dim * 2, cfg.z_dim * 2, device, kernel=1)
        self.conv2 = _conv3(cfg.z_dim, cfg.z_dim, device, kernel=1)
        self.decoder = Decoder3d(cfg, device)

    def encode_chunk(self, video, st: Optional[Stream], first: bool):
        """[B, Tc, H, W, 3] -> [B, T'c, h, w, z] fp32, given a stream's state
        (None: a whole clip)."""
        x = video.permute(0, 4, 1, 2, 3).to(self.conv1.weight.dtype)
        mu = _conv(self.conv1, self.encoder(x, st, first))[:, :self.cfg.z_dim]
        mean, std = _scale(self.cfg.z_dim, mu.device)
        return ((mu.float() - mean) / std).permute(0, 2, 3, 4, 1)

    def decode_chunk(self, z, st: Optional[Stream], first: bool, dtype=torch.float32):
        """[B, Tc, h, w, z] -> [B, T, H, W, 3] clamped fp32 in ``dtype``'s
        stream (bf16: convs, activations and caches; norms in fp32)."""
        mean, std = _scale(self.cfg.z_dim, z.device)
        x = (z.permute(0, 4, 1, 2, 3).float() * std + mean).to(dtype)
        x = self.decoder(_conv(self.conv2, x), st, first)
        return torch.clamp(x.float(), -1.0, 1.0).permute(0, 2, 3, 4, 1)

    @torch.no_grad()
    def encode(self, video):
        return self.encode_chunk(video, None, True)

    @torch.no_grad()
    def decode(self, z):
        return self.decode_chunk(z, None, True)


@torch.no_grad()
def init_params(vae: WanVAE, generator: torch.Generator) -> WanVAE:
    """Seeded weights in place, for runs without released weights: convs
    and dense layers uniform in +-sqrt(3 / fan_in) (unit variance gain),
    biases near 0 and the RMS gains near 1."""
    for name, p in vae.named_parameters():
        r = torch.rand(p.shape, generator=generator, device=generator.device) * 2.0 - 1.0
        r = r.to(p.device)
        if name.endswith("gamma"):
            p.copy_(1.0 + 0.1 * r)
        elif name.endswith("bias"):
            p.copy_(0.05 * r)
        else:
            fan_in = p[0].numel()
            p.copy_(r * math.sqrt(3.0 / fan_in))
    return vae


@torch.no_grad()
def encode_streaming(vae: WanVAE, video, frames_per_chunk: int = 4):
    """Pixel frames 1, then ``frames_per_chunk`` at a time (a multiple of
    the temporal stride); equals ``vae.encode``."""
    t_stride = vae.cfg.stride[0]
    if frames_per_chunk % t_stride:
        raise ValueError(f"chunk {frames_per_chunk} must divide by the temporal stride {t_stride}")
    st, outs, i, t = {}, [], 0, video.shape[1]
    while i < t:
        n = 1 if i == 0 else min(frames_per_chunk, t - i)
        outs.append(vae.encode_chunk(video[:, i:i + n], st, first=(i == 0)))
        i += n
    return torch.cat(outs, dim=1)


@torch.no_grad()
def decode_streaming(vae: WanVAE, z, frames_per_chunk: int = 1, dtype=torch.float32):
    """Latent frames 1, then ``frames_per_chunk`` at a time; equals
    ``vae.decode`` in fp32. Each chunk's frames move to the CPU as it
    completes, so the device holds the caches and one chunk, never the
    clip; the frames come back on the CPU."""
    st, outs, i, t = {}, [], 0, z.shape[1]
    while i < t:
        n = 1 if i == 0 else min(frames_per_chunk, t - i)
        outs.append(vae.decode_chunk(z[:, i:i + n], st, first=(i == 0), dtype=dtype).cpu())
        i += n
    return torch.cat(outs, dim=1)


@torch.no_grad()
def decode(vae: WanVAE, z, chunk: int = -1, dtype=torch.float32):
    """The CLIs' decode, frames on the CPU: ``chunk`` latent frames a step
    (0: the whole clip; -1: stream one at a time above 5 latent frames, as
    the JAX CLI does)."""
    if chunk < 0:
        chunk = 1 if z.shape[1] > 5 else 0
    if chunk == 0:
        return vae.decode_chunk(z, None, True, dtype=dtype).cpu()
    return decode_streaming(vae, z, chunk, dtype=dtype)
