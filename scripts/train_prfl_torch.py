"""PRFL post-training CLI of the PyTorch port (counterpart of
scripts/train_prfl.py).

    python scripts/train_prfl_torch.py --config_path configs/train_prfl_t2v_480.yaml \
        [--max_steps N] [--device cuda]

Every outer step runs one PRFL reward ("refl") step and then one
flow-matching SFT step on the same batch, as the JAX loop does, and logs
refl_loss, reward, grad_norm, sft_loss, t_refl and t_sft (wall seconds,
each after a device synchronize) as one JSON line. Each outer step draws
from a generator seeded by (train.seed, step), and a resumed run replays
the data stream up to its step, so it reads and draws what an
uninterrupted one does.

``build_trainer(config, device)`` and ``run(trainer, steps)`` are separate
so a caller can give the trainer other weights between the two. Without a
base checkpoint the policy and the LRM start from the JAX initialisers
(seeded), as the JAX CLI does without weights. The LRM comes from
``model.lrm_transformer_path`` (a reference checkpoint directory: the
PAVRM trainer's trimmed head-less export, or a whole transformer, sliced
to the blocks the feature taps need) and the heads from
``model.lrm_mlp_path`` and ``model.lrm_query_attention_path``. At every
``train.save_interval`` the policy goes to ``<out>/checkpoint-<n>`` in the
reference layout, with ``opt_state/`` (the AdamW moments and the step)
under ``train.save_optimizer_state`` and the EMA (``model.ema.use_ema``)
to ``<out>-ema/checkpoint-<n>``; ``model.resume_transformer_path`` resumes
from such a directory (the policy; the moments and the step where
``opt_state/`` is there; the EMA where ``<out>-ema/checkpoint-<n>`` is).
Options the port does not have yet raise NotImplementedError: LoRA, multi-device training,
optimizer-state offload and the VAE sanity decode. ``train.rollout_quant:
int8`` runs the no-grad rollout through the int8 serving path (W8A8 block
matmuls, int8 q k^T self-attention), as the JAX trainer does. An i2v or
flf2v task (``i2v-1.3b``, ``i2v-14b-480p``, ...) conditions every step on
the cache's first-frame latent and CLIP features, as the JAX trainer does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from typing import Any, Dict, List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hyvideo_prfl_torch.configs import dit_cfg_from  # noqa: E402
from hyvideo_prfl_torch.data.dataset import LatentCacheDataset  # noqa: E402
from hyvideo_prfl_torch.models import wan_dit  # noqa: E402
from hyvideo_prfl_torch.schedulers import flow_match as fm  # noqa: E402
from hyvideo_prfl_torch.training import cli, common, ema as ema_mod  # noqa: E402
from hyvideo_prfl_torch.training.pavrm import PavrmConfig  # noqa: E402
from hyvideo_prfl_torch.training.prfl import (  # noqa: E402
    PrflConfig, PrflModel, make_refl_step, make_sft_step,
)
from hyvideo_prfl_torch.utils import checkpoint as ck  # noqa: E402


@dataclasses.dataclass
class Trainer:
    config: Any
    device: torch.device
    model: PrflModel
    state: common.TrainState
    loader: Any
    refl_fn: Any
    sft_fn: Any
    out_dir: str
    seed: int
    step: int = 0  # the next outer step
    ema: Any = None  # fp32 copies of state.params under model.ema.use_ema


def build_trainer(config, device="cuda") -> Trainer:
    """Model (fp32 policy masters + frozen LRM), optimizer, data, steps."""
    device = cli.start(config, device, **{
        "LoRA (model.lora.use_lora)": config.get_path("model.lora.use_lora"),
        "the VAE sanity decode (extra_model.vae.params_path)":
            cli.exists(config.get_path("extra_model.vae.params_path"))})
    dit_cfg = dit_cfg_from(config)
    is_i2v = "i2v" in config.task or "flf2v" in config.task
    is_flf2v = "flf2v" in config.task
    pc = PavrmConfig(
        pool=config.lrm.pool,
        feature_layer=tuple(config.lrm.feature_layer),
        trainable_blocks=tuple(config.lrm.trainable_blocks),
        num_queries=config.lrm.query_attention.num_queries,
        num_heads=config.lrm.query_attention.num_heads,
        return_type=config.lrm.query_attention.return_type)
    sched_cfg = config.extra_model.scheduler
    prfl_cfg = PrflConfig(
        inference_steps=int(config.get("prfl_inference_steps", 40)),
        flow_shift=sched_cfg.flow_shift, num_train_timesteps=sched_cfg.num_train_timesteps,
        weighting_scheme=sched_cfg.weighting_scheme, logit_mean=sched_cfg.logit_mean,
        logit_std=sched_cfg.logit_std, is_i2v=is_i2v, is_flf2v=is_flf2v,
        fixed_mid=(int(config.train.fixed_mid)
                   if config.train.get("fixed_mid") is not None else None),
        rollout_quant=config.train.get("rollout_quant"))
    model = PrflModel(dit_cfg, pc, prfl_cfg, device=device)
    seed = int(config.train.seed)
    resume = config.model.resume_transformer_path
    base = config.model.init_transformer_path or config.model.base_path
    start_step = 0
    if cli.exists(resume):
        logging.info("resuming the policy from %s", resume)
        model.dit.load_state_dict(ck.load_reference_dir(resume, dit_cfg))
        start_step = ck.parse_resume_step(resume)
    elif cli.exists(base):
        logging.info("loading policy base from %s", base)
        model.dit.load_state_dict(ck.load_reference_dir(base, dit_cfg))
    else:
        logging.info("no base checkpoint; seeded JAX-initialiser weights")
        wan_dit.init_params(model.dit, torch.Generator(device=device).manual_seed(seed))
    if cli.exists(config.model.lrm_transformer_path):
        logging.info("loading the LRM from %s", config.model.lrm_transformer_path)
        model.lrm.load_reference(config.model.lrm_transformer_path, config.model.lrm_mlp_path,
                                 config.model.lrm_query_attention_path)
    else:
        logging.info("no LRM checkpoint; seeded JAX-initialiser weights")
        model.lrm.init_params(torch.Generator(device=device).manual_seed(1))

    tx = common.optimizer_from_config(config)
    state = common.init_train_state(model.dit, tx)
    if cli.exists(resume) and os.path.isdir(os.path.join(resume, "opt_state")):
        # the moments of train.save_optimizer_state and the step, which
        # counts the optimizer calls, two per outer step
        ck.load_opt_state(os.path.join(resume, "opt_state"), state)
        logging.info("restored the optimizer state from %s/opt_state", resume)
    ema = None
    if config.model.ema.use_ema:
        ema = ema_mod.ema_init(state.params)
        # a resumed run from <out>/checkpoint-<n> continues <out>-ema/checkpoint-<n>
        head, tail = os.path.split(os.path.normpath(resume or "."))
        ema_dir = os.path.join(head + "-ema", tail)
        if cli.exists(resume) and os.path.isdir(ema_dir):
            saved = ck.load_reference_dir(ema_dir, dit_cfg)
            for name, e in zip(state.names, ema):
                e.copy_(saved[name])
            logging.info("restored the EMA from %s", ema_dir)

    dataset = LatentCacheDataset(
        meta_file_list=list(config.dataset.meta_file_list),
        uncond_prob=list(config.dataset.uncond_prob),
        text_len=config.extra_model.get_path("text_encoder.t5_text_len", 512),
        null_dir=config.dataset.null_dir, is_i2v=is_i2v, is_flf2v=is_flf2v, seed=seed)
    loader = cli.make_loader(dataset, config, seed, start_step)
    out_dir = os.path.join(config.save.output_dir, config.train_id)
    return Trainer(config=config, device=device, model=model, state=state,
                   loader=loader, refl_fn=make_refl_step(model, tx),
                   sft_fn=make_sft_step(model, tx, fm.train_schedule(
                       sched_cfg.num_train_timesteps)),
                   out_dir=out_dir, seed=seed, step=start_step, ema=ema)


def save_checkpoint(trainer: Trainer, step: int) -> None:
    """The policy in the reference layout at <out>/checkpoint-<step>, its
    optimizer state under train.save_optimizer_state, and the EMA at
    <out>-ema/checkpoint-<step>."""
    config, model, state = trainer.config, trainer.model, trainer.state
    path = ck.save_reference_dir(model.dit.state_dict(), model.dit_cfg, trainer.out_dir, step)
    if config.train.get("save_optimizer_state"):
        ck.save_opt_state(os.path.join(path, "opt_state"), state)
    if trainer.ema is not None:
        ema_state = {**model.dit.state_dict(), **dict(zip(state.names, trainer.ema))}
        ck.save_reference_dir(ema_state, model.dit_cfg, trainer.out_dir + "-ema", step)
    logging.info("saved %s", path)


def run(trainer: Trainer, steps: int) -> List[Dict[str, float]]:
    """``steps`` more outer steps (refl then SFT); returns their metrics."""
    config = trainer.config
    log = cli.log_path(config, trainer.out_dir)
    sanity_dir = config.save.sanity_check_dir or os.path.join(trainer.out_dir, "sanity_check")
    interval = int(config.train.sanity_check_interval)
    dev = trainer.device
    history = []
    for step in range(trainer.step, trainer.step + steps):
        raw = next(trainer.loader)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()
                 if not isinstance(v, list)}
        gen = common.step_generator(dev, trainer.seed + 2, step)
        cli.sync(dev)
        t0 = time.perf_counter()
        trainer.state, m_refl = trainer.refl_fn(trainer.state, batch, gen)
        cli.sync(dev)
        t_refl = time.perf_counter() - t0
        if interval > 0 and step <= 50 and step % interval == 0:
            # the sanity dumps, as latents (the VAE decode is not ported)
            os.makedirs(sanity_dir, exist_ok=True)
            for name in ("pred_x0", "latent_next"):
                np.save(os.path.join(sanity_dir, f"step{step}_{name}.npy"),
                        m_refl[name].float().cpu().numpy())
        t0 = time.perf_counter()
        trainer.state, m_sft = trainer.sft_fn(trainer.state, batch, gen)
        cli.sync(dev)
        t_sft = time.perf_counter() - t0
        if trainer.ema is not None:
            ema_mod.ema_update(trainer.ema, trainer.state.params,
                               float(config.model.ema.ema_decay))
        metrics = {"step": step, "refl_loss": float(m_refl["loss"]),
                   "reward": float(m_refl["reward"]), "grad_norm": float(m_refl["grad_norm"]),
                   "sft_loss": float(m_sft["loss"]), "mid": int(m_refl["mid"]),
                   "t_refl": t_refl, "t_sft": t_sft}
        cli.log_line(log, metrics)
        if (step + 1) % 100 == 0:
            health = common.validate_params(trainer.model.dit)
            if not health["finite"]:
                logging.error("NON-FINITE PARAMS: %s", health["bad"][:5])
        if (step + 1) % int(config.train.save_interval) == 0:
            save_checkpoint(trainer, step + 1)
        history.append(metrics)
    trainer.step += steps
    return history


def main(argv=None) -> List[Dict[str, float]]:
    return cli.main(build_trainer, run, argv)


if __name__ == "__main__":
    main()
