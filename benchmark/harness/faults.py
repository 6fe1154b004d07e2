"""Faults planted in the program's timed path, to show that the comparison
catches them: ``state`` (every optimizer update leaves the parameters and
moments as they were), ``answer`` (the answer altered where it is made:
the rollout's last latent and the reward model's logit in a PRFL step,
each solver step's latent in serving) and ``half``
(half of the CFG batch left out: the conditional half stands for both).

Each is a monkeypatch of the program's own modules, undone by the
returned function. ``run.py --fault`` plants one for a calibration run;
the CPU tests plant them at a tiny size.
"""

from __future__ import annotations

from typing import Callable, List


def plant(name: str, kind: str) -> Callable[[], None]:
    import torch

    undo: List[tuple] = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "state":
        from hyvideo_prfl_torch.training import common as tc

        patch(tc.Optimizer, "update", lambda self, *a, **k: None)
    elif name == "answer":
        from hyvideo_prfl_torch.models import reward
        from hyvideo_prfl_torch.schedulers import unipc

        if kind == "train_prfl":
            patch(reward, "reward_sigmoid", lambda logits: torch.sigmoid(logits + 0.1))
            rollout = unipc.rollout

            def altered_rollout(*args, **kw):
                x, state = rollout(*args, **kw)
                return x * 1.01, state

            patch(unipc, "rollout", altered_rollout)
        if kind == "serve":
            apply = unipc._apply

            def altered_step(c, state, v, x):
                nxt, state = apply(c, state, v, x)
                return nxt * 1.01, state

            patch(unipc, "_apply", altered_step)
    elif name == "half":
        from hyvideo_prfl_torch.pipelines import pipeline

        def cond_only(self, x, t, context, context_null, guide_scale, grid, y=None,
                      clip_fea=None):
            t1 = torch.full((x.shape[0],), t, dtype=torch.float32, device=x.device)
            return self.model(x, t1, context, grid=grid)

        patch(pipeline.WanPipeline, "_velocity_cfg", cond_only)
    else:
        raise ValueError(f"unknown fault {name!r}")

    def restore():
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)

    return restore
