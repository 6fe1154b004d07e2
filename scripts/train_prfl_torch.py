"""PRFL post-training CLI of the PyTorch port (counterpart of
scripts/train_prfl.py).

    python scripts/train_prfl_torch.py --config_path configs/train_prfl_t2v_480.yaml \
        [--max_steps N] [--device cuda]
    torchrun --nproc_per_node 4 scripts/train_prfl_torch.py \
        --config_path configs/train_prfl_t2v_720.yaml

Under torchrun each process drives one GPU (NCCL; gloo with --device
cpu) on the ("data", "sp") mesh: sp = min(dataset.sp_size, world),
data = world // sp. The policy and the frozen LRM are sharded with FSDP2
under model.fsdp.fsdp_sharding_startegy (full, hybrid_full,
shard_grad_op, hybrid_zero2, none), the tokens split over the sp ranks
(Ulysses self-attention, token-parallel cross-attention), each data
replica reads its own block of the dataset, and rank 0 logs, dumps and
writes the gathered checkpoints. model.fsdp.use_cpu_offload or
train.offload_opt_state keeps the AdamW moments in pinned host memory
between steps, at every world size.

Every outer step runs one PRFL reward ("refl") step and then one
flow-matching SFT step on the same batch, as the JAX loop does, and logs
refl_loss, reward, grad_norm, sft_loss, t_refl and t_sft (wall seconds,
each after a device synchronize) as one JSON line. Each outer step is a
``train.step`` span holding ``train.batch`` (the loader's next batch and
its copy to the device), the steps' phases (training/prfl.py) and
``train.log`` (the EMA and the metrics' reads); with tracing on
(utils/tracing.py: ``HYV_TRACE=1``, or a torch.profiler recording) the
line, written once the step's spans have closed, also holds ``trace``:
the step's spans (calls, host and device milliseconds) and the counters'
increments. The logger's own time (its start, each line's write, its
close) is ``train.record``, in the next line's trace. Each outer step draws
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
At every ``train.sanity_check_interval`` within the first 50 steps the
refl step's ``pred_x0`` and ``latent_next`` go to ``save.sanity_check_dir``
(``<out>/sanity_check`` by default): decoded in-process by the VAE of
``extra_model.vae.params_path`` (a reference ``.pth``, ``Wan2.1_VAE.pth``;
streamed one latent frame at a time), written as mp4 or, without a
writer, uint8 ``_frames.npy``; as latents ``.npy`` where no VAE is given,
as the JAX trainer does. ``model.lora.use_lora`` trains rank
``lora_rank`` factors of ``target_modules`` (the self- and cross-attention
q/k/v/o) on a frozen base (training/lora.py): the optimizer moments and
the EMA hold the factors alone, a checkpoint is the merged DiT with the
factors beside it in three key formats, and a resumed LoRA run takes that
merged DiT as its base under fresh factors, as the JAX trainer does.
``train.rollout_quant: int8`` with a process group raises
NotImplementedError. ``train.rollout_quant:
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
from hyvideo_prfl_torch.models import vae as vae_mod  # noqa: E402
from hyvideo_prfl_torch.models import wan_dit  # noqa: E402
from hyvideo_prfl_torch.parallel import sharding  # noqa: E402
from hyvideo_prfl_torch.schedulers import flow_match as fm  # noqa: E402
from hyvideo_prfl_torch.training import cli, common, ema as ema_mod  # noqa: E402
from hyvideo_prfl_torch.training import lora as lora_mod  # noqa: E402
from hyvideo_prfl_torch.training.pavrm import PavrmConfig  # noqa: E402
from hyvideo_prfl_torch.training.prfl import (  # noqa: E402
    PrflConfig, PrflModel, make_refl_step, make_sft_step, parallelize,
)
from hyvideo_prfl_torch.utils import checkpoint as ck  # noqa: E402
from hyvideo_prfl_torch.utils import encoders, safetensors_io, tracing, video_io  # noqa: E402

LORA_FORMATS = ("transformer", "kohya", "diffusers")
# the JAX trainer's TensorBoard scalars, train/<key>
TB_KEYS = ("refl_loss", "reward", "sft_loss", "grad_norm", "t_refl", "t_sft")


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
    ema: Any = None  # fp32 copies of the local parameter shards under model.ema.use_ema
    vae: Any = None  # the sanity decode's VAE (extra_model.vae.params_path)
    mesh: sharding.Mesh = dataclasses.field(default_factory=sharding.Mesh)
    lora: bool = False  # model.lora.use_lora: the state holds the factors alone


def build_trainer(config, device="cuda") -> Trainer:
    """Model (fp32 policy masters + frozen LRM, sharded over the mesh),
    optimizer, data, steps."""
    device = cli.start(config, device)
    mesh = cli.mesh_for(config, device)
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
    use_lora = bool(config.get_path("model.lora.use_lora"))
    if use_lora:
        # the base frozen, the factors trained (the JAX lora_init's seed + 1)
        lora = config.model.lora
        tree = lora_mod.lora_init(
            model.dit, int(lora.lora_rank), tuple(lora.target_modules),
            generator=torch.Generator(device=device).manual_seed(seed + 1))
        lora_mod.attach_lora(model.dit, tree)
        logging.info("LoRA rank %d on %s: the base is frozen", int(lora.lora_rank),
                     list(lora.target_modules))
    if cli.exists(config.model.lrm_transformer_path):
        logging.info("loading the LRM from %s", config.model.lrm_transformer_path)
        model.lrm.load_reference(config.model.lrm_transformer_path, config.model.lrm_mlp_path,
                                 config.model.lrm_query_attention_path)
    else:
        logging.info("no LRM checkpoint; seeded JAX-initialiser weights")
        model.lrm.init_params(torch.Generator(device=device).manual_seed(1))

    layout = parallelize(model, mesh, sharding.fsdp_strategy_from(config))
    tx = common.optimizer_from_config(config)
    state = common.init_train_state(model.dit, tx, layout, sharding.offload_from(config))
    # a LoRA run resumes as the JAX trainer does: its merged checkpoint is
    # the new base under fresh factors, with fresh moments and EMA
    if cli.exists(resume) and os.path.isdir(os.path.join(resume, "opt_state")) \
            and not use_lora:
        # the moments of train.save_optimizer_state and the step, which
        # counts the optimizer calls, two per outer step
        ck.load_opt_state(os.path.join(resume, "opt_state"), state)
        logging.info("restored the optimizer state from %s/opt_state", resume)
    ema = None
    if config.model.ema.use_ema:
        ema = ema_mod.ema_init(state.local_params())
        # a resumed run from <out>/checkpoint-<n> continues <out>-ema/checkpoint-<n>
        head, tail = os.path.split(os.path.normpath(resume or "."))
        ema_dir = os.path.join(head + "-ema", tail)
        if cli.exists(resume) and os.path.isdir(ema_dir) and not use_lora:
            saved = ck.load_reference_dir(ema_dir, dit_cfg)
            for name, p, e in zip(state.names, state.params, ema):
                e.copy_(sharding.shard_of(saved[name], p))
            logging.info("restored the EMA from %s", ema_dir)

    dataset = LatentCacheDataset(
        meta_file_list=list(config.dataset.meta_file_list),
        uncond_prob=list(config.dataset.uncond_prob),
        text_len=config.extra_model.get_path("text_encoder.t5_text_len", 512),
        null_dir=config.dataset.null_dir, is_i2v=is_i2v, is_flf2v=is_flf2v, seed=seed)
    loader = cli.make_loader(dataset, config, seed, start_step, mesh)
    out_dir = os.path.join(config.save.output_dir, config.train_id)
    vae_path = config.get_path("extra_model.vae.params_path")
    vae = None
    if cli.exists(vae_path) and mesh.is_main:
        logging.info("sanity decodes through the VAE of %s", vae_path)
        vae = encoders.load_reference_vae(vae_path, device)
    return Trainer(config=config, device=device, model=model, state=state,
                   loader=loader, refl_fn=make_refl_step(model, tx, mesh),
                   sft_fn=make_sft_step(model, tx, fm.train_schedule(
                       sched_cfg.num_train_timesteps), mesh),
                   out_dir=out_dir, seed=seed, step=start_step, ema=ema, vae=vae, mesh=mesh,
                   lora=use_lora)


def save_checkpoint(trainer: Trainer, step: int) -> None:
    """The policy in the reference layout at <out>/checkpoint-<step>, its
    optimizer state under train.save_optimizer_state, and the EMA at
    <out>-ema/checkpoint-<step>: gathered on every rank, written by rank 0.
    Under LoRA, as the JAX trainer saves: the base with the factors merged,
    the factors alone beside it in the three key formats
    (``lora_{transformer,kohya,diffusers}.safetensors``, the self-attention
    q/k factors in the reference's rope layout), no optimizer state, and
    the EMA's factors merged into the base."""
    config, model, state, mesh = trainer.config, trainer.model, trainer.state, trainer.mesh
    main = mesh.is_main
    full = sharding.full_state_dict(model.dit, main)
    opt = (common.gathered_opt_state(state, main)
           if config.train.get("save_optimizer_state") and not trainer.lora else None)
    ema = (sharding.gather_to_host(trainer.ema, state.params, main)
           if trainer.ema is not None else None)
    if main:
        cfg = model.dit_cfg
        if trainer.lora:
            base, tree = lora_mod.split_lora_state(full)
            path = ck.save_reference_dir(lora_mod.merged_state(base, tree), cfg,
                                         trainer.out_dir, step)
            for fmt in LORA_FORMATS:
                safetensors_io.write_file(
                    lora_mod.lora_state_dict(tree, fmt, head_dim=cfg.head_dim),
                    os.path.join(path, f"lora_{fmt}.safetensors"))
        else:
            path = ck.save_reference_dir(full, cfg, trainer.out_dir, step)
        if opt is not None:
            ck.save_opt_state(os.path.join(path, "opt_state"), opt)
        if ema is not None:
            named = dict(zip(state.names, ema))
            ema_state = (lora_mod.merged_state(base, lora_mod.lora_tree(named))
                         if trainer.lora else {**full, **named})
            ck.save_reference_dir(ema_state, cfg, trainer.out_dir + "-ema", step)
        logging.info("saved %s", path)
    mesh.barrier()


def sanity_dump(trainer: Trainer, sanity_dir: str, step: int, m_refl) -> None:
    """The refl step's pred_x0 and latent_next: decoded to a video grid
    with the VAE, else saved as latents."""
    os.makedirs(sanity_dir, exist_ok=True)
    for name in ("pred_x0", "latent_next"):
        lat = m_refl[name].float()
        stem = os.path.join(sanity_dir, f"step{step}_{name}")
        if trainer.vae is None:
            np.save(stem + ".npy", lat.cpu().numpy())
            continue
        video = vae_mod.decode(trainer.vae, lat, chunk=1)
        logging.info("sanity decode %s -> %s", tuple(lat.shape),
                     video_io.save_videos_grid(video, stem + ".mp4"))


def run(trainer: Trainer, steps: int) -> List[Dict[str, float]]:
    """``steps`` more outer steps (refl then SFT); returns their metrics."""
    config = trainer.config
    with tracing.span("train.record"):
        logger = cli.MetricLogger(config, trainer.out_dir, trainer.mesh.is_main)
    sanity_dir = config.save.sanity_check_dir or os.path.join(trainer.out_dir, "sanity_check")
    interval = int(config.train.sanity_check_interval)
    dev, main = trainer.device, trainer.mesh.is_main
    history = []
    for step in range(trainer.step, trainer.step + steps):
        with tracing.span("train.step", step):
            with tracing.span("train.batch"):
                raw = next(trainer.loader)
                batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()
                         if not isinstance(v, list)}
            gen = common.step_generator(dev, trainer.seed + 2, step)
            cli.sync(dev)
            t0 = time.perf_counter()
            trainer.state, m_refl = trainer.refl_fn(trainer.state, batch, gen)
            cli.sync(dev)
            t_refl = time.perf_counter() - t0
            if interval > 0 and step <= 50 and step % interval == 0 and main:
                sanity_dump(trainer, sanity_dir, step, m_refl)
            t0 = time.perf_counter()
            trainer.state, m_sft = trainer.sft_fn(trainer.state, batch, gen)
            cli.sync(dev)
            t_sft = time.perf_counter() - t0
            with tracing.span("train.log"):
                if trainer.ema is not None:
                    ema_mod.ema_update(trainer.ema, trainer.state.local_params(),
                                       float(config.model.ema.ema_decay))
                metrics = {"step": step, "refl_loss": float(m_refl["loss"]),
                           "reward": float(m_refl["reward"]),
                           "grad_norm": float(m_refl["grad_norm"]),
                           "sft_loss": float(m_sft["loss"]), "mid": int(m_refl["mid"]),
                           "t_refl": t_refl, "t_sft": t_sft}
        with tracing.span("train.record", step):  # in the next line's trace
            if tracing.enabled():
                metrics["trace"] = tracing.drain()
            logger.log(metrics, step, {k: metrics[k] for k in TB_KEYS})
        if (step + 1) % 100 == 0:
            health = common.validate_params(trainer.model.dit)
            if not health["finite"]:
                logging.error("NON-FINITE PARAMS: %s", health["bad"][:5])
        if (step + 1) % int(config.train.save_interval) == 0:
            save_checkpoint(trainer, step + 1)
        history.append(metrics)
    with tracing.span("train.record"):
        logger.close()
    trainer.step += steps
    return history


def main(argv=None) -> List[Dict[str, float]]:
    return cli.main(build_trainer, run, argv)


if __name__ == "__main__":
    main()
