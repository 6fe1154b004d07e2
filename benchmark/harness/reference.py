"""The plain reference the benchmark holds the program to.

Plain PyTorch, float32 with TF32 off: the Wan2.1 video DiT (t2v), the
PAVRM reward tower with its query-attention pool and reward MLP, the
flow-matching UniPC solver (order 2, bh2, x0 prediction) and the
global-norm clip + AdamW of the training recipes. It imports nothing of
the program and nothing of JAX: it reads weights from a dict keyed by
the names the benchmark gives them (``weights.py``), in the program's
conventions (token cells patchified as [pt, ph, pw, C], q and k in the
"half" rope layout: x[..., i] pairs with x[..., D/2 + i]).

``precision="fp8"`` is the control: every matrix product the program runs
in bf16 (the block and embedding linears, both attentions) takes its
inputs rounded to float8 e4m3 with one scale per tensor, the gradient
passing straight through; the fp32 parts stay fp32.

Attention is computed in blocks of queries with its own backward (the
probabilities are recomputed from the saved log-sum-exp), so a 32,760-token
sequence fits.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6
FP8_MAX = 448.0
# bytes of one block of attention scores, [B, H, chunk, Lk] fp32
SCORE_BYTES = 2 << 30


def strict_fp32() -> None:
    """Float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------- precision

def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one absmax scale, straight-through."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


class Prec:
    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "fp8"

    def cast(self, x):
        return fp8(x) if self.low else x

    def linear(self, x, w, b):
        """A product the program runs in bf16."""
        return F.linear(self.cast(x), self.cast(w), b)


def linear32(x, w, b):
    """A product the program runs in fp32."""
    return F.linear(x, w, b)


# ---------------------------------------------------------------- attention

class _Attention(torch.autograd.Function):
    """softmax(q k^T / sqrt(D)) v over [B, H, L, D] fp32, in query blocks."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, h, lq, d = q.shape
        lk = k.shape[2]
        chunk = max(16, min(lq, SCORE_BYTES // (4 * b * h * lk)))
        scale = d ** -0.5
        o = torch.empty_like(q)
        lse = q.new_empty((b, h, lq))
        kt = k.transpose(-1, -2)
        for s in range(0, lq, chunk):
            sc = torch.matmul(q[:, :, s:s + chunk], kt).mul_(scale)
            m = sc.amax(-1, keepdim=True)
            p = sc.sub_(m).exp_()
            l = p.sum(-1, keepdim=True)
            o[:, :, s:s + chunk] = torch.matmul(p, v).div_(l)
            lse[:, :, s:s + chunk] = (m + l.log()).squeeze(-1)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.chunk = chunk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        chunk = ctx.chunk
        scale = q.shape[-1] ** -0.5
        do = do.contiguous()
        delta = (do * o).sum(-1)
        dq = torch.empty_like(q)
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
        for s in range(0, q.shape[2], chunk):
            qs, dos = q[:, :, s:s + chunk], do[:, :, s:s + chunk]
            p = torch.matmul(qs, kt).mul_(scale).sub_(lse[:, :, s:s + chunk, None]).exp_()
            dv += torch.matmul(p.transpose(-1, -2), dos)
            ds = torch.matmul(dos, vt).sub_(delta[:, :, s:s + chunk, None]).mul_(p)
            del p
            dq[:, :, s:s + chunk] = torch.matmul(ds, k) * scale
            dk += torch.matmul(ds.transpose(-1, -2), qs) * scale
        return dq, dk, dv


def attention(q, k, v, prec: Prec):
    """[B, L, H, D] q, k, v -> [B, L, H, D]."""
    q, k, v = (prec.cast(t).transpose(1, 2).contiguous() for t in (q, k, v))
    return _Attention.apply(q, k, v).transpose(1, 2)


def attention_naive(q, k, v):
    """The same, all scores at once (tests)."""
    s = torch.einsum("blhd,bkhd->bhlk", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhlk,bkhd->blhd", torch.softmax(s, -1), v)


# ---------------------------------------------------------------- the DiT

def patchify(x: torch.Tensor, patch=(1, 2, 2)):
    """[B, F, H, W, C] -> ([B, L, pt*ph*pw, C], grid)."""
    b, f, hh, ww, c = x.shape
    pt, ph, pw = patch
    gf, gh, gw = f // pt, hh // ph, ww // pw
    xp = x.reshape(b, gf, pt, gh, ph, gw, pw, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return xp.reshape(b, gf * gh * gw, pt * ph * pw, c), (gf, gh, gw)


def unpatchify(tokens: torch.Tensor, grid, patch=(1, 2, 2)) -> torch.Tensor:
    b, _, _, c = tokens.shape
    gf, gh, gw = grid
    pt, ph, pw = patch
    out = tokens.reshape(b, gf, gh, gw, pt, ph, pw, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return out.reshape(b, gf * pt, gh * ph, gw * pw, c)


def rope_tables(grid, head_dim: int, device, theta: float = 10000.0):
    """[L, D] tables C = [cos|cos], S = [-sin|sin]: the half-dim splits into
    bands (c - 2 (c // 3), c // 3, c // 3) for frames, rows and columns,
    angles in float64."""
    f, h, w = grid
    c = head_dim // 2
    bands = (c - 2 * (c // 3), c // 3, c // 3)

    def ang(n, dim):
        inv = 1.0 / np.power(theta, np.arange(dim, dtype=np.float64) / dim)
        return np.outer(np.arange(n, dtype=np.float64), inv)

    at, ah, aw = ang(f, bands[0]), ang(h, bands[1]), ang(w, bands[2])
    a = np.concatenate([
        np.broadcast_to(at[:, None, None], (f, h, w, bands[0])),
        np.broadcast_to(ah[None, :, None], (f, h, w, bands[1])),
        np.broadcast_to(aw[None, None, :], (f, h, w, bands[2]))], -1).reshape(f * h * w, c)
    cos, sin = np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)
    tc = torch.from_numpy(np.concatenate([cos, cos], -1)).to(device)
    ts = torch.from_numpy(np.concatenate([-sin, sin], -1)).to(device)
    return tc, ts


def layer_norm(x):
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    return xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + EPS)


def rms_heads(x, w, heads: int):
    """RMSNorm over the whole width, times the gain -> [B, L, H, D]."""
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w
    return y.reshape(*x.shape[:2], heads, -1)


def rope(x, tc, ts):
    """x [B, L, H, D] rotated: x C + roll(x, D/2) S."""
    half = x.shape[-1] // 2
    rolled = torch.cat([x[..., half:], x[..., :half]], -1)
    return x * tc[None, :, None] + rolled * ts[None, :, None]


def sinusoid(dim: int, t: torch.Tensor) -> torch.Tensor:
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=t.device) / half)
    a = torch.outer(t.float(), freqs)
    return torch.cat([torch.cos(a), torch.sin(a)], 1)


class DiT:
    """The Wan2.1 t2v DiT over a weight dict ``P`` (keys as the benchmark
    names them, under ``prefix``)."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: dict, prefix: str = "",
                 precision: str = "fp32", remat: bool = False):
        self.P, self.cfg, self.pre = P, cfg, prefix
        self.prec = Prec(precision)
        self.remat = remat
        self.heads = cfg["num_heads"]
        self.patch = tuple(cfg["patch_size"])

    def w(self, name):
        return self.P[self.pre + name]

    def lin(self, name, x):
        return self.prec.linear(x, self.w(name + ".weight"), self.w(name + ".bias"))

    def lin32(self, name, x):
        return linear32(x, self.w(name + ".weight"), self.w(name + ".bias"))

    def embed(self, tokens, t, context):
        """-> (h [B, L, dim], e [B, dim], e0 [B, 6, dim], ctx [B, Lt, dim])."""
        b, l, cells, c = tokens.shape
        h = self.lin("patch_embedding", tokens.reshape(b, l, cells * c))
        t = torch.as_tensor(t, dtype=torch.float32, device=h.device).reshape(-1).expand(b)
        e = self.lin32("time_2", F.silu(self.lin32("time_0", sinusoid(self.cfg["freq_dim"], t))))
        e0 = self.lin32("time_proj", F.silu(e)).view(b, 6, -1)
        ctx = self.lin("text_2", F.gelu(self.lin("text_0", context), approximate="tanh"))
        return h, e, e0, ctx

    def block(self, i, x, e0, ctx, tc, ts):
        p = f"blocks.{i}."
        n = self.heads
        e6 = self.w(p + "modulation") + e0
        h = layer_norm(x) * (1 + e6[:, 1:2]) + e6[:, 0:1]
        q = rope(rms_heads(self.lin(p + "self_attn.q", h), self.w(p + "self_attn.norm_q"), n),
                 tc, ts)
        k = rope(rms_heads(self.lin(p + "self_attn.k", h), self.w(p + "self_attn.norm_k"), n),
                 tc, ts)
        v = self.lin(p + "self_attn.v", h).reshape(q.shape)
        o = attention(q, k, v, self.prec).reshape(x.shape)
        x = x + self.lin(p + "self_attn.o", o) * e6[:, 2:3]
        h = layer_norm(x) * self.w(p + "norm3_scale") + self.w(p + "norm3_bias")
        q = rms_heads(self.lin(p + "cross_attn.q", h), self.w(p + "cross_attn.norm_q"), n)
        k = rms_heads(self.lin(p + "cross_attn.k", ctx), self.w(p + "cross_attn.norm_k"), n)
        v = self.lin(p + "cross_attn.v", ctx).reshape(k.shape)
        o = attention(q, k, v, self.prec).reshape(x.shape)
        x = x + self.lin(p + "cross_attn.o", o)
        h = layer_norm(x) * (1 + e6[:, 4:5]) + e6[:, 3:4]
        h = self.lin(p + "ffn_2", F.gelu(self.lin(p + "ffn_0", h), approximate="tanh"))
        return x + h * e6[:, 5:6]

    def blocks(self, h, e0, ctx, grid, n_blocks: int):
        tc, ts = rope_tables(grid, self.cfg["dim"] // self.heads, h.device)
        for i in range(n_blocks):
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(self.block, i, h, e0, ctx, tc, ts, use_reentrant=False)
            else:
                h = self.block(i, h, e0, ctx, tc, ts)
        return h

    def __call__(self, tokens, t, context, grid):
        """Token cells [B, L, cells, C] -> velocity [B, L, cells, out_dim]."""
        h, e, e0, ctx = self.embed(tokens, t, context)
        h = self.blocks(h, e0, ctx, grid, self.cfg["num_layers"])
        e2 = self.w("head.modulation") + e[:, None]
        h = layer_norm(h) * (1 + e2[:, 1:2]) + e2[:, 0:1]
        out = self.lin32("head.head", h)
        return out.reshape(*tokens.shape[:3], self.cfg["out_dim"])

    def features(self, tokens, t, context, grid, layer: int):
        """The residual stream after block ``layer`` [B, L, dim]."""
        h, _, e0, ctx = self.embed(tokens, t, context)
        return self.blocks(h, e0, ctx, grid, layer)


class RewardModel:
    """PAVRM: the tower's features after ``layer`` blocks, the
    query-attention pool (one query, ``pool_heads`` heads, the mean query
    added) and the 3-layer reward MLP -> logits [B, 1]. fp32 heads."""

    def __init__(self, P, cfg: dict, layer: int, pool_heads: int, precision: str = "fp32",
                 remat: bool = False):
        self.P, self.layer, self.pool_heads = P, layer, pool_heads
        self.tower = DiT(P, cfg, "dit.", precision, remat)

    def __call__(self, tokens, t, context, grid):
        f = self.tower.features(tokens, t, context, grid, self.layer)
        P = self.P
        b, l, d = f.shape
        nh = self.pool_heads
        hd = d // nh
        qry = P["q_attn.queries"]
        q = (qry @ P["q_attn.wq"] + P["q_attn.bq"])[None].expand(b, -1, -1)
        k = f @ P["q_attn.wk"] + P["q_attn.bk"]
        v = f @ P["q_attn.wv"] + P["q_attn.bv"]
        s = torch.einsum("bqnd,bknd->bnqk", q.reshape(b, -1, nh, hd),
                         k.reshape(b, l, nh, hd)) / math.sqrt(hd)
        a = torch.einsum("bnqk,bknd->bqnd", torch.softmax(s, -1), v.reshape(b, l, nh, hd))
        pooled = (a.reshape(b, -1, d) @ P["q_attn.wo"] + P["q_attn.bo"]).mean(1)
        pooled = pooled + qry.mean(0)[None]
        x = F.relu(linear32(pooled, P["mlp.Dense_0.weight"], P["mlp.Dense_0.bias"]))
        x = F.relu(linear32(x, P["mlp.Dense_1.weight"], P["mlp.Dense_1.bias"]))
        return linear32(x, P["mlp.Dense_2.weight"], P["mlp.Dense_2.bias"])


# ---------------------------------------------------------------- solver

def unipc_table(steps: int, shift: float, n_train: int = 1000):
    """(sigmas [steps + 1], timesteps [steps], rows): the flow-matching UniPC
    multistep solver (order 2, bh2, x0 prediction, lower order at the end,
    final sigma 0, corrector on) as one row of float64 coefficients a step."""
    sig = np.linspace((n_train - 1) / n_train, 0.0, steps + 1, dtype=np.float64)[:-1]
    sig = shift * sig / (1.0 + (shift - 1.0) * sig)
    timesteps = sig * n_train
    sig = np.concatenate([sig, [0.0]])

    def lam(s):
        s = max(s, 1e-20)
        return math.log1p(-s) - math.log(s)

    rows = []
    for i in range(steps):
        r = {"sigma": sig[i], "corr": i > 0, "a_c": 0.0, "b_c": 0.0, "c_c": 0.0, "d_c": 0.0}
        if i > 0:
            st, s0 = sig[i], sig[i - 1]
            h = lam(st) - lam(s0)
            hh = -h
            phi1 = math.expm1(hh)
            k1 = phi1 / hh - 1.0
            b1 = k1 / phi1
            b2 = (k1 / hh - 0.5) * 2.0 / phi1
            r["a_c"], r["b_c"] = st / s0, -(1 - st) * phi1
            if min(2, steps - (i - 1), i) >= 2:
                rr = (lam(sig[i - 2]) - lam(s0)) / h
                c0 = (b1 - b2) / (1.0 - rr)
                r["c_c"] = -(1 - st) * phi1 * c0 / rr
                r["d_c"] = -(1 - st) * phi1 * (b1 - c0)
            else:
                r["d_c"] = -(1 - st) * phi1 * 0.5
        st, s0 = sig[i + 1], sig[i]
        if st <= 0.0:
            r.update(a_p=0.0, b_p=1.0, c_p=0.0)
        else:
            h = lam(st) - lam(s0)
            phi1 = math.expm1(-h)
            r.update(a_p=st / s0, b_p=-(1 - st) * phi1, c_p=0.0)
            if min(2, steps - i, i + 1) >= 2:
                rr = (lam(sig[i - 1]) - lam(s0)) / h
                r["c_p"] = -(1 - st) * phi1 * 0.5 / rr
        rows.append(r)
    return sig, timesteps, rows


class UniPC:
    """The solver's state (last two x0 predictions, the sample before the
    last predictor) and its step."""

    def __init__(self, steps: int, shift: float):
        self.sigmas, self.timesteps, self.rows = unipc_table(steps, shift)
        self.m0 = self.m1 = self.last = None
        self.i = 0

    def step(self, v, x):
        r = self.rows[self.i]
        m_t = x - r["sigma"] * v
        if r["corr"]:
            x = r["a_c"] * self.last + r["b_c"] * self.m0 + r["d_c"] * (m_t - self.m0)
            if r["c_c"]:
                x = x + r["c_c"] * (self.m1 - self.m0)
        nxt = r["a_p"] * x + r["b_p"] * m_t
        if r["c_p"]:
            nxt = nxt + r["c_p"] * (self.m0 - m_t)
        self.m1, self.m0, self.last = self.m0, m_t, x
        self.i += 1
        return nxt


# ---------------------------------------------------------------- training

def train_sigmas(n_train: int = 1000) -> np.ndarray:
    """The flow-matching training sigmas 1 -> 0 over n_train + 1 points, fp32."""
    return np.linspace(1.0, 0.0, n_train + 1).astype(np.float32)


def sigma_at(t: float, n_train: int = 1000) -> float:
    """The training sigma of the timestep nearest to t."""
    sig = train_sigmas(n_train)
    ts = sig[:-1] * np.float32(n_train)
    return float(sig[int(np.abs(ts - np.float32(t)).argmin())])


class AdamW:
    """Global-norm clip, then AdamW (eps outside the sqrt, decoupled decay on
    every parameter), by parameter groups {name: lr}."""

    def __init__(self, params: Dict[str, torch.Tensor], lr_of, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01, max_grad_norm=1.0):
        self.params, self.lr_of = params, lr_of
        self.b1, self.b2, self.eps, self.wd, self.clip = b1, b2, eps, weight_decay, max_grad_norm
        self.m = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the clipped gradients' per-leaf norms."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        bc1 = 1.0 - self.b1 ** (self.count + 1)
        bc2 = 1.0 - self.b2 ** (self.count + 1)
        norms = {}
        for n, p in self.params.items():
            g = grads[n] * scale
            norms[n] = float(g.norm())
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1) / ((v / bc2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr_of(n) * u)
        self.count += 1
        return norms


def grads_of(params: Dict[str, torch.Tensor], finite: bool) -> Dict[str, torch.Tensor]:
    """The parameters' gradients, taken off them (zeros under a non-finite loss)."""
    out = {}
    for n, p in params.items():
        g = p.grad
        out[n] = torch.zeros_like(p) if g is None or not finite else g
        p.grad = None
    return out


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||; inf where the shapes differ."""
    if got.shape != ref.shape:
        return float("inf")
    ref = ref.detach().float()
    return float((got.detach().float() - ref).norm() / ref.norm().clamp_min(1e-30))


def max_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|; inf where the shapes differ."""
    if got.shape != ref.shape:
        return float("inf")
    ref = ref.detach().float()
    return float((got.detach().float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
