"""EMA of the trainable parameters (hyvideo_prfl_tpu/training/ema.py,
config model.ema).

The EMA is a second fp32 copy of the trainable parameters, on their
device, updated in place after each outer training step:
``e = decay * e + (1 - decay) * p``, each product rounded to fp32 before
the sum as the JAX update rounds them, as ``_foreach`` ops over chunks of
parameters (no temporary the size of the model).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

_CHUNK = 64


def ema_init(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A distinct fp32 copy of ``params``."""
    return [p.detach().to(torch.float32, copy=True) for p in params]


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float = 0.99) -> List[torch.Tensor]:
    """ema = decay * ema + (1 - decay) * params, in place; returns ema."""
    for i in range(0, len(ema), _CHUNK):
        e = ema[i:i + _CHUNK]
        torch._foreach_mul_(e, decay)
        torch._foreach_add_(e, torch._foreach_mul(
            [p.detach().float() for p in params[i:i + _CHUNK]], 1.0 - decay))
    return ema
