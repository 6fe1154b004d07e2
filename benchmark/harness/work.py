"""The work one step of a cell needs, counted from its shapes: each
kernel call's operations and bytes, and the least time the card could
take for it (its bound).

A call's bound is the larger of its operations over the peak rate of its
type and its bytes over the memory rate, each input byte read once and
each output byte written once. Attention forward is 4 B H Lq Lk D
operations, its backward 10 B H Lq Lk D. Every dense product is 2 M K N;
its backward is the products the step needs: the weight's gradient where
the weight trains, the input's where a gradient flows into it. Each
forward pass is counted once and each backward once: the recomputation
under activation checkpointing is not work the step needs.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity): 989
TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

PEAK = {"bytes": 3.35e12, "bf16": 989e12, "fp32": 67e12}
SIZE = {"bf16": 2, "fp32": 4}


def bound_s(nbytes: float, ops: float, kind: str = "bf16") -> float:
    return max(nbytes / PEAK["bytes"], ops / PEAK[kind])


@dataclasses.dataclass
class Work:
    attn_fwd_s: float = 0.0
    attn_bwd_s: float = 0.0
    gemm_s: float = 0.0
    flops: float = 0.0

    def add(self, other: "Work", times: float = 1.0) -> "Work":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + times * getattr(other, f.name))
        return self


def attn_fwd(b, h, lq, lk, d) -> Work:
    ops = 4.0 * b * h * lq * lk * d
    nbytes = 2.0 * b * h * d * (2 * lq + 2 * lk)  # q, o; k, v (bf16)
    return Work(attn_fwd_s=bound_s(nbytes, ops), flops=ops)


def attn_bwd(b, h, lq, lk, d) -> Work:
    ops = 10.0 * b * h * lq * lk * d
    # q, o, do, dq and k, v, dk, dv (bf16), the lse (fp32)
    nbytes = 2.0 * b * h * d * (4 * lq + 4 * lk) + 4.0 * b * h * lq
    return Work(attn_bwd_s=bound_s(nbytes, ops), flops=ops)


def gemm(m, k, n, kind="bf16") -> Work:
    ops = 2.0 * m * k * n
    nbytes = SIZE[kind] * (m * k + k * n + m * n)
    return Work(gemm_s=bound_s(nbytes, ops, kind), flops=ops)


# (name, M, K, N, kind) of one forward; names say which rule of the backward applies
Gemm = Tuple[str, int, int, int, str]


def dit_gemms(cfg: dict, b: int, l: int, lt: int, layers: int, head: bool) -> List[Gemm]:
    d, f = cfg["dim"], cfg["ffn_dim"]
    cells = 1
    for p in cfg["patch_size"]:
        cells *= p
    out = [("patch", b * l, cells * cfg["in_dim"], d, "bf16"),
           ("text_0", b * lt, cfg["text_dim"], d, "bf16"), ("text_2", b * lt, d, d, "bf16"),
           ("time_0", b, cfg["freq_dim"], d, "fp32"), ("time_2", b, d, d, "fp32"),
           ("time_proj", b, d, 6 * d, "fp32")]
    block = ([("self", b * l, d, d, "bf16")] * 4
             + [("cross_q", b * l, d, d, "bf16"), ("cross_o", b * l, d, d, "bf16")]
             + [("cross_kv", b * lt, d, d, "bf16")] * 2
             + [("ffn_0", b * l, d, f, "bf16"), ("ffn_2", b * l, f, d, "bf16")])
    out += block * layers
    if head:
        out.append(("head", b * l, d, cells * cfg["out_dim"], "fp32"))
    return out


def dit_attention(cfg: dict, b: int, l: int, lt: int, layers: int) -> List[Tuple[int, ...]]:
    h = cfg["num_heads"]
    d = cfg["dim"] // h
    return [(b, h, l, l, d), (b, h, l, lt, d)] * layers


# which products of the backward a part of a step needs, by forward name:
# (the weight's gradient, the input's gradient)
TRAINED_POLICY = {  # the PRFL policy: all of it trains; latents and text need none
    "patch": (True, False), "text_0": (True, False), "text_2": (True, True),
    "time_0": (True, False), "time_2": (True, True), "time_proj": (True, True),
    "self": (True, True), "cross_q": (True, True), "cross_o": (True, True),
    "cross_kv": (True, True), "ffn_0": (True, True), "ffn_2": (True, True),
    "head": (True, True)}
FROZEN_SCORER = {  # the frozen LRM: the gradient flows to its input latents alone
    "patch": (False, True), "self": (False, True), "cross_q": (False, True),
    "cross_o": (False, True), "ffn_0": (False, True), "ffn_2": (False, True)}


def forward(cfg, b, l, lt, layers, head=True) -> Work:
    w = Work()
    for _, m, k, n, kind in dit_gemms(cfg, b, l, lt, layers, head):
        w.add(gemm(m, k, n, kind))
    for shape in dit_attention(cfg, b, l, lt, layers):
        w.add(attn_fwd(*shape))
    return w


def backward(cfg, b, l, lt, layers, rules: Dict[str, Tuple[bool, bool]],
             head=True) -> Work:
    w = Work()
    for name, m, k, n, kind in dit_gemms(cfg, b, l, lt, layers, head):
        dw, dx = rules.get(name, (False, False))
        if dw:
            w.add(gemm(k, m, n, kind))
        if dx:
            w.add(gemm(m, n, k, kind))
    for shape in dit_attention(cfg, b, l, lt, layers):
        w.add(attn_bwd(*shape))
    return w


def pool(cfg, b, l) -> Work:
    """The frozen query-attention pool's key and value projections over
    every token (fp32; its one query and the reward MLP are negligible):
    forward, and backward into the features."""
    d = cfg["dim"]
    w = Work().add(gemm(b * l, d, d, "fp32"), 2)
    return w.add(gemm(b * l, d, d, "fp32"), 2)  # the input's gradient


def prfl_step(cfg, l, lt, mid, lrm_layers) -> Work:
    """One outer PRFL step at batch 1: ``mid`` rollout forwards, the
    policy's forward and backward, the frozen LRM's forward and backward
    into its input, its pool, then the SFT step's forward and backward."""
    n = cfg["num_layers"]
    w = Work().add(forward(cfg, 1, l, lt, n), mid)
    for _ in range(2):  # the refl step's policy pass, the SFT step's
        w.add(forward(cfg, 1, l, lt, n)).add(backward(cfg, 1, l, lt, n, TRAINED_POLICY))
    w.add(forward(cfg, 1, l, lt, lrm_layers, head=False))
    w.add(backward(cfg, 1, l, lt, lrm_layers, FROZEN_SCORER, head=False))
    return w.add(pool(cfg, 1, l))


def sample_step(cfg, l, lt, cfg_batch=2) -> Work:
    """One sampling step: one batched-CFG forward (the solver's elementwise
    passes are negligible)."""
    return forward(cfg, cfg_batch, l, lt, cfg["num_layers"])
