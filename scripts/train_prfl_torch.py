"""PRFL post-training CLI of the PyTorch port (counterpart of
scripts/train_prfl.py).

    python scripts/train_prfl_torch.py --config_path configs/train_prfl_t2v_480.yaml \
        [--max_steps N] [--device cuda]

Every outer step runs one PRFL reward ("refl") step and then one
flow-matching SFT step on the same batch, as the JAX loop does, and logs
refl_loss, reward, grad_norm, sft_loss, t_refl and t_sft (wall seconds,
each after a device synchronize) as one JSON line.

``build_trainer(config, device)`` and ``run(trainer, steps)`` are separate
so a caller can give the trainer other weights between the two. Without a
base checkpoint the policy and the LRM start from the JAX initialisers
(seeded), as the JAX CLI does without weights. Options the port does not
have yet raise NotImplementedError: LoRA, EMA, the int8 rollout,
multi-device training, resume, checkpoint export (save_interval must
exceed the steps run), LRM checkpoint loading and the VAE sanity decode.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hyvideo_prfl_torch.configs import dit_config_for_task, load_config  # noqa: E402
from hyvideo_prfl_torch.data.dataset import LatentCacheDataset  # noqa: E402
from hyvideo_prfl_torch.data.loader import BatchIterator, BlockDistributedSampler  # noqa: E402
from hyvideo_prfl_torch.models import wan_dit  # noqa: E402
from hyvideo_prfl_torch.schedulers import flow_match as fm  # noqa: E402
from hyvideo_prfl_torch.training import common  # noqa: E402
from hyvideo_prfl_torch.training.pavrm import PavrmConfig  # noqa: E402
from hyvideo_prfl_torch.training.prfl import (  # noqa: E402
    PrflConfig, PrflModel, make_refl_step, make_sft_step,
)
from hyvideo_prfl_torch.utils import checkpoint as ck  # noqa: E402


def dit_cfg_from(config) -> wan_dit.WanConfig:
    """task -> WanConfig, with model.gradient_checkpointing (remat),
    model.remat_policy and model.override applied (scripts/_common.py)."""
    cfg = dit_config_for_task(config.task)
    gc = config.get_path("model.gradient_checkpointing")
    if gc is not None:
        cfg = dataclasses.replace(cfg, remat=bool(gc))
    rp = config.get_path("model.remat_policy")
    if rp:
        cfg = dataclasses.replace(cfg, remat_policy=str(rp))
    ov = config.get_path("model.override")
    if ov:
        cfg = dataclasses.replace(cfg, **{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in ov.items()})
    return cfg


def _exists(path) -> bool:
    return bool(path) and os.path.exists(path)


def check_scope(config) -> None:
    """Raise NotImplementedError for a config option the port lacks."""
    asks = {
        "LoRA (model.lora.use_lora)": config.get_path("model.lora.use_lora"),
        "EMA (model.ema.use_ema)": config.get_path("model.ema.use_ema"),
        "the int8 rollout (train.rollout_quant)": config.get_path("train.rollout_quant"),
        "multi-device training (dataset.sp_size > 1)":
            int(config.get_path("dataset.sp_size", 1) or 1) > 1,
        "optimizer-state offload (model.fsdp.use_cpu_offload, train.offload_opt_state)":
            config.get_path("model.fsdp.use_cpu_offload")
            or config.get_path("train.offload_opt_state"),
        "resume (model.resume_transformer_path)":
            config.get_path("model.resume_transformer_path"),
        "optimizer-state export (train.save_optimizer_state)":
            config.get_path("train.save_optimizer_state"),
        "LRM checkpoint loading (model.lrm_transformer_path)":
            _exists(config.get_path("model.lrm_transformer_path")),
        "the VAE sanity decode (extra_model.vae.params_path)":
            _exists(config.get_path("extra_model.vae.params_path")),
    }
    missing = [name for name, on in asks.items() if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {'; '.join(missing)}")


@dataclasses.dataclass
class Trainer:
    config: Any
    device: torch.device
    model: PrflModel
    state: common.TrainState
    loader: Any
    refl_fn: Any
    sft_fn: Any
    generator: torch.Generator
    out_dir: str


def build_trainer(config, device="cuda") -> Trainer:
    """Model (fp32 policy masters + frozen LRM), optimizer, data, steps."""
    check_scope(config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (pass --device cpu for a CPU run)")
    if config.train.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
    dit_cfg = dit_cfg_from(config)
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
        logit_std=sched_cfg.logit_std,
        fixed_mid=(int(config.train.fixed_mid)
                   if config.train.get("fixed_mid") is not None else None))
    model = PrflModel(dit_cfg, pc, prfl_cfg, device=device)
    seed = int(config.train.seed)
    base = config.model.init_transformer_path or config.model.base_path
    if _exists(base):
        logging.info("loading policy base from %s", base)
        model.dit.load_state_dict(ck.load_reference_dir(base, dit_cfg))
    else:
        logging.info("no base checkpoint; seeded JAX-initialiser weights")
        wan_dit.init_params(model.dit, torch.Generator(device=device).manual_seed(seed))
    model.lrm.init_params(torch.Generator(device=device).manual_seed(1))

    opt = config.optimizer
    tx = common.make_optimizer(
        learning_rate=opt.learning_rate, adam_beta1=opt.adam_beta1, adam_beta2=opt.adam_beta2,
        adam_epsilon=opt.get("adam_epsilon", 1e-8), weight_decay=opt.weight_decay,
        lr_scheduler=opt.lr_scheduler, lr_warmup_steps=opt.lr_warmup_steps,
        lr_num_cycles=int(opt.get("lr_num_cycles", 1)), lr_power=float(opt.get("lr_power", 1.0)),
        max_train_steps=opt.max_train_steps,
        max_grad_norm=float(opt.get("max_grad_norm", 1.0)),
        gradient_accumulation_steps=config.train.gradient_accumulation_steps)
    state = common.init_train_state(model.dit, tx)

    dataset = LatentCacheDataset(
        meta_file_list=list(config.dataset.meta_file_list),
        uncond_prob=list(config.dataset.uncond_prob),
        text_len=config.extra_model.get_path("text_encoder.t5_text_len", 512),
        null_dir=config.dataset.null_dir, seed=seed)
    sampler = BlockDistributedSampler(len(dataset), shuffle=bool(config.dataset.get("shuffle")),
                                      seed=seed)
    loader = iter(BatchIterator(dataset, sampler, batch_size=config.dataset.batch_size))
    out_dir = os.path.join(config.save.output_dir, config.train_id)
    return Trainer(config=config, device=device, model=model, state=state,
                   loader=loader, refl_fn=make_refl_step(model, tx),
                   sft_fn=make_sft_step(model, tx, fm.train_schedule(
                       sched_cfg.num_train_timesteps)),
                   generator=torch.Generator(device=device).manual_seed(seed + 2),
                   out_dir=out_dir)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(trainer: Trainer, steps: int) -> List[Dict[str, float]]:
    """``steps`` more outer steps (refl then SFT); returns their metrics."""
    config = trainer.config
    start = trainer.state.step // 2  # two optimizer calls per outer step
    if int(config.train.save_interval) <= start + steps:
        raise NotImplementedError(
            f"checkpoint export is not ported yet: save_interval "
            f"({config.train.save_interval}) must exceed the {start + steps} steps run")
    os.makedirs(trainer.out_dir, exist_ok=True)
    log_dir = config.save.log_dir or os.path.join(trainer.out_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    sanity_dir = config.save.sanity_check_dir or os.path.join(trainer.out_dir, "sanity_check")
    interval = int(config.train.sanity_check_interval)
    dev = trainer.device
    history = []
    for step in range(start, start + steps):
        raw = next(trainer.loader)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()
                 if not isinstance(v, list)}
        _sync(dev)
        t0 = time.perf_counter()
        trainer.state, m_refl = trainer.refl_fn(trainer.state, batch, trainer.generator)
        _sync(dev)
        t_refl = time.perf_counter() - t0
        if interval > 0 and step <= 50 and step % interval == 0:
            # the sanity dumps, as latents (the VAE decode is not ported)
            os.makedirs(sanity_dir, exist_ok=True)
            for name in ("pred_x0", "latent_next"):
                np.save(os.path.join(sanity_dir, f"step{step}_{name}.npy"),
                        m_refl[name].float().cpu().numpy())
        t0 = time.perf_counter()
        trainer.state, m_sft = trainer.sft_fn(trainer.state, batch, trainer.generator)
        _sync(dev)
        t_sft = time.perf_counter() - t0
        metrics = {"step": step, "refl_loss": float(m_refl["loss"]),
                   "reward": float(m_refl["reward"]), "grad_norm": float(m_refl["grad_norm"]),
                   "sft_loss": float(m_sft["loss"]), "mid": int(m_refl["mid"]),
                   "t_refl": t_refl, "t_sft": t_sft}
        line = json.dumps(metrics)
        print(line, flush=True)
        with open(os.path.join(log_dir, "log.txt"), "a") as f:
            f.write(line + "\n")
        if (step + 1) % 100 == 0:
            health = common.validate_params(trainer.model.dit)
            if not health["finite"]:
                logging.error("NON-FINITE PARAMS: %s", health["bad"][:5])
        history.append(metrics)
    return history


def main(argv=None) -> List[Dict[str, float]]:
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = load_config(args.config_path)
    trainer = build_trainer(config, args.device)
    return run(trainer, args.max_steps or int(config.optimizer.max_train_steps))


if __name__ == "__main__":
    main()
