"""The plain reference against the program at a tiny size on the CPU: the
DiT and the reward model with the program computing in fp32, the blocked
attention and its backward against all scores at once, the solver and
the optimizer step for step."""

import numpy as np
import pytest
import torch

from harness import reference as R, weights as W

CFG = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32, text_dim=64,
           in_dim=16, out_dim=16, patch_size=[1, 2, 2])


def _program_cfg():
    from hyvideo_prfl_torch.models import wan_dit

    return wan_dit.WanConfig(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32,
                             text_dim=64, compute_dtype=torch.float32, remat=False)


def test_dit_matches_the_program_in_fp32():
    from hyvideo_prfl_torch.models import wan_dit

    P = W.make(W.dit_leaves(CFG, 2), 123, "cpu")
    model = wan_dit.WanModel(_program_cfg(), device="cpu", param_dtype=torch.float32)
    model.load_state_dict(P, strict=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 12, 16, generator=g)
    ctx = torch.randn(2, 512, 64, generator=g)
    t = torch.tensor([900.0, 300.0])
    tok, grid = wan_dit.patchify(x, (1, 2, 2))
    with torch.no_grad():
        got = model(tok, t, ctx, grid=grid)
        ref = R.DiT(P, CFG)(R.patchify(x)[0], t, ctx, grid)
    assert R.rel_l2(got, ref) < 1e-5


def test_reward_model_matches_the_program_in_fp32():
    from hyvideo_prfl_torch.training.pavrm import PavrmConfig, PavrmModel

    P = W.make(W.reward_leaves(CFG, 2), 5, "cpu")
    pm = PavrmModel(_program_cfg(), PavrmConfig(feature_layer=(2,), trainable_blocks=(0, 1)),
                    device="cpu", param_dtype=torch.float32)
    pm.load_state_dict(P, strict=True)
    g = torch.Generator().manual_seed(1)
    x, ctx = torch.randn(2, 3, 8, 12, 16, generator=g), torch.randn(2, 512, 64, generator=g)
    t = torch.tensor([400.0, 700.0])
    with torch.no_grad():
        got = pm.score(x, t, ctx)
        tok, grid = R.patchify(x)
        ref = R.RewardModel(P, CFG, 2, 8)(tok, t, ctx, grid)
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_blocked_attention_and_its_backward(monkeypatch):
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 40, 2, 16, generator=g, requires_grad=True) for _ in range(3))
    monkeypatch.setattr(R, "SCORE_BYTES", 4 * 2 * 2 * 40 * 16)  # blocks of 16 queries
    got = R.attention(q, k, v, R.Prec())
    ref = R.attention_naive(q, k, v)
    do = torch.randn(got.shape, generator=g)
    for a, b in zip(torch.autograd.grad(got, (q, k, v), do),
                    torch.autograd.grad(ref, (q, k, v), do)):
        assert R.rel_l2(a, b) < 1e-5
    assert R.rel_l2(got, ref) < 1e-5


def test_fp8_control_rounds_the_products():
    x = torch.linspace(-3, 3, 1001)
    q = R.fp8(x)
    err = (q - x).abs().max() / x.abs().max()
    assert 1e-3 < err < 0.07  # e4m3: 3 mantissa bits


def test_unipc_matches_the_program_step_for_step():
    from hyvideo_prfl_torch.schedulers import unipc

    sched = unipc.unipc_schedule(12, 5.0)
    mine = R.UniPC(12, 5.0)
    assert np.allclose(mine.timesteps, sched.timesteps, rtol=1e-6)
    g = torch.Generator().manual_seed(3)
    xp = torch.randn(1, 5, 4, 16, generator=g)
    xr, state = xp.clone(), unipc.init_state(xp)
    for i in range(12):
        v = torch.randn(xp.shape, generator=g)
        xp, state = unipc._apply(sched.row(i), state, v, xp)
        xr = mine.step(v, xr)
        assert R.rel_l2(xr, xp) < 1e-5


@pytest.mark.parametrize("clip", [False, True])
def test_adamw_matches_the_program_optimizer(clip):
    from hyvideo_prfl_torch.training import common as tc

    g = torch.Generator().manual_seed(4)
    params = {"q_attn.w": torch.randn(6, 5, generator=g), "blocks.0.w": torch.randn(7, generator=g)}
    tx = tc.make_optimizer(learning_rate=1e-3, learning_rate_mlp=1e-2,
                           max_grad_norm=0.5 if clip else 1e3)
    prog = [p.clone() for p in params.values()]
    state = tx.init(prog, list(params))
    mine = R.AdamW({n: p.clone() for n, p in params.items()},
                   lambda n: 1e-2 if n.startswith("q_attn") else 1e-3,
                   max_grad_norm=0.5 if clip else 1e3)
    for step in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in prog]
        mine.step({n: gr.clone() for n, gr in zip(params, grads)})
        tx.update(prog, [gr.clone() for gr in grads], state, step)
    for got, ref in zip(prog, mine.params.values()):
        assert torch.allclose(got, ref, rtol=1e-6, atol=1e-8)
