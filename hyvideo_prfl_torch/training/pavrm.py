"""The latent reward model, LRM half of hyvideo_prfl_tpu/training/pavrm.py.

``PavrmModel`` is the first ``max(feature_layer)`` blocks of the DiT with no
head, a QueryAttention pool and a RewardMLP; ``score`` maps noisy latents
to reward logits. PRFL holds it frozen. The PAVRM trainer is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..models import reward as rw
from ..models import wan_dit


@dataclasses.dataclass(frozen=True)
class PavrmConfig:
    """The lrm.* fields the reward model reads (configs/train_*.yaml); the
    PAVRM trainer's loss and timestep fields come with that trainer."""

    pool: str = "q_attn"  # q_attn | mean | max
    feature_layer: Tuple[int, ...] = (8,)
    trainable_blocks: Tuple[int, ...] = tuple(range(8))
    num_queries: int = 1
    num_heads: int = 8
    return_type: Optional[str] = "query"


def trimmed_config(cfg: wan_dit.WanConfig, num_blocks: int) -> wan_dit.WanConfig:
    return dataclasses.replace(cfg, num_layers=num_blocks)


class PavrmModel(nn.Module):
    """Trimmed head-less DiT + QueryAttention pool + RewardMLP."""

    def __init__(self, dit_cfg: wan_dit.WanConfig, pc: PavrmConfig, device=None):
        super().__init__()
        self.pc = pc
        n_blocks = max(pc.feature_layer)
        if n_blocks > dit_cfg.num_layers:
            raise ValueError(f"feature_layer {pc.feature_layer} exceeds "
                             f"{dit_cfg.num_layers} blocks")
        # every shipped config trains exactly the kept blocks; a strict
        # subset would need a mask (the JAX package asserts the same)
        kept = tuple(b for b in pc.trainable_blocks if b < n_blocks)
        if pc.trainable_blocks and kept != tuple(range(n_blocks)):
            raise ValueError(f"trainable_blocks must cover range({n_blocks})")
        self.dit_cfg = trimmed_config(dit_cfg, n_blocks)
        # frozen in PRFL: its dense weights are stored in the compute dtype
        self.dit = wan_dit.WanModel(self.dit_cfg, device=device, with_head=False)
        self.q_attn = rw.QueryAttention(dit_cfg.dim, pc.num_queries, pc.num_heads,
                                        pc.return_type, device=device)
        self.mlp = rw.RewardMLP(dit_cfg.dim, device=device)

    def init_params(self, generator: torch.Generator):
        """The JAX initialisers for the tower and both heads."""
        wan_dit.init_params(self.dit, generator)
        self.q_attn.init_params(generator)
        self.mlp.init_params(generator)
        return self

    def score(self, noisy_latents, t, text, grid=None):
        """Noisy latents (video, or token cells with ``grid``) -> reward
        logits [B, 1] (pre-sigmoid)."""
        feats = self.dit(noisy_latents, t, text, grid=grid, output_features=True,
                         selected_layers=self.pc.feature_layer)
        pooled = rw.pool_features(feats, self.pc.pool, self.q_attn)
        return self.mlp(pooled)
