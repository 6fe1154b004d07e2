"""PAVRM reward-model training CLI of the PyTorch port (counterpart of
scripts/train_pavrm.py).

    python scripts/train_pavrm_torch.py --config_path configs/train_pavrm_t2v_480.yaml \
        [--max_steps N] [--device cuda]
    torchrun --nproc_per_node 4 scripts/train_pavrm_torch.py \
        --config_path configs/train_pavrm_t2v_720.yaml

The model is the first max(lrm.feature_layer) blocks of the task's DiT with
no head, a QueryAttention pool and a RewardMLP; the blocks and both heads
train as fp32 masters (the heads at optimizer.learning_rate_mlp where it is
set), the embeddings stay frozen. lrm.loss "ce" reads a labelled cache
(dataset_type lrm_ce, the label lrm.task), "bt" pairs each sample with a
random entry of dataset.meta_file_lose_list. Each step logs loss,
grad_norm, acc and step_time (wall seconds after a device synchronize) as
one JSON line, and draws from a generator seeded by (train.seed, step).
A resumed run replays the data stream up to its step, so it reads and
draws what an uninterrupted run does (hyvideo_prfl_torch/data/loader.py).

``build_trainer(config, device)`` and ``run(trainer, steps)`` are separate,
as in scripts/train_prfl_torch.py. Base weights come from model.base_path
(a reference checkpoint directory, sliced to the kept blocks); without one
the tower and the heads take the seeded JAX initialisers. At every
train.save_interval: the trainable state goes to ``<out>/checkpoint-<n>``
and, under train.save_optimizer_state, the optimizer state to
``<out>/checkpoint-<n>-opt`` (torch.save files; model.resume_transformer_path
resumes from them, the step parsed from the name); ``export_lrm_artifacts``
writes the PRFL handoff (unless train.save_reference_artifacts is false);
and the val set (dataset.val_meta_file_list) is scored at eval.timestep.
Under torchrun the tower and the heads are sharded with FSDP2 and the
tokens split over the sp ranks, as in scripts/train_prfl_torch.py; rank 0
logs and writes the gathered state. model.fsdp.use_cpu_offload or
train.offload_opt_state keeps the AdamW moments in pinned host memory.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from typing import Any, Dict, List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hyvideo_prfl_torch.parallel import sharding  # noqa: E402

from hyvideo_prfl_torch.configs import dit_cfg_from  # noqa: E402
from hyvideo_prfl_torch.schedulers import flow_match as fm  # noqa: E402
from hyvideo_prfl_torch.training import cli, common  # noqa: E402
from hyvideo_prfl_torch.training.pavrm import (  # noqa: E402
    PavrmModel, evaluate, labelled_dataset, make_eval_step, make_train_step,
    pavrm_config_from,
)
from hyvideo_prfl_torch.utils import checkpoint as ck  # noqa: E402


@dataclasses.dataclass
class Trainer:
    config: Any
    device: torch.device
    model: PavrmModel
    state: common.TrainState
    loader: Any
    step_fn: Any
    eval_fn: Any
    val_dataset: Any
    out_dir: str
    seed: int
    step: int = 0  # the next step
    mesh: sharding.Mesh = dataclasses.field(default_factory=sharding.Mesh)


def build_trainer(config, device="cuda") -> Trainer:
    """Model (fp32 masters of the kept blocks and the heads, frozen
    embeddings), optimizer, data, steps."""
    device = cli.start(config, device)
    mesh = cli.mesh_for(config, device)
    dit_cfg = dit_cfg_from(config)
    pc = pavrm_config_from(config)
    seed = int(config.train.seed)
    model = PavrmModel(dit_cfg, pc, device=device, param_dtype=torch.float32)
    model.init_params(torch.Generator(device=device).manual_seed(seed))
    base = config.model.base_path
    if cli.exists(base):
        logging.info("loading the base DiT from %s", base)
        model.dit.load_state_dict(ck.load_tower_dir(base, dit_cfg, model.dit_cfg.num_layers))
    else:
        logging.info("no base checkpoint; seeded JAX-initialiser weights")
    model.freeze_embeddings()

    resume = config.model.get("resume_transformer_path")
    start_step = 0
    if cli.exists(resume):
        resume = os.path.normpath(resume)
        logging.info("resuming the PAVRM trainable state from %s", resume)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        ck.load_trainable(resume, [n for n, _ in named], [p for _, p in named])
        start_step = ck.parse_resume_step(resume)
    layout = model.parallelize(mesh, sharding.fsdp_strategy_from(config))
    tx = common.optimizer_from_config(config)
    state = common.init_train_state(model, tx, layout, sharding.offload_from(config))
    if cli.exists(resume):
        if os.path.isdir(resume + "-opt"):
            ck.load_opt_state(resume + "-opt", state)  # the moments and the step
            logging.info("restored the optimizer state from %s-opt", resume)

    ds_type = "lrm_ce" if pc.loss == "ce" else "lrm_bt_online"
    dataset = labelled_dataset(config, pc, config.dataset.meta_file_list, seed, ds_type,
                               config.dataset.get("meta_file_lose_list") or ())
    loader = cli.make_loader(dataset, config, seed, start_step, mesh)
    val_lists = list(config.dataset.get("val_meta_file_list") or [])
    val_dataset = (labelled_dataset(config, pc, val_lists, int(config.eval.seed))
                   if val_lists else None)
    return Trainer(config=config, device=device, model=model, state=state, loader=loader,
                   step_fn=make_train_step(model, tx, fm.train_schedule(
                       pc.num_train_timesteps), mesh),
                   eval_fn=make_eval_step(model), val_dataset=val_dataset,
                   out_dir=os.path.join(config.save.output_dir, config.train_id),
                   seed=seed, step=start_step, mesh=mesh)


def export_lrm_artifacts(model: PavrmModel, out_dir: str, step: int,
                         main: bool = True) -> None:
    """The PRFL handoff in the reference layout (scripts/train_pavrm.py
    ``export_lrm_artifacts``): ``transformer/checkpoint-<step>/``, the
    trimmed head-less tower (safetensors and a config.json with its
    num_layers), and ``mlp/mlp_step_<step>.ckpt`` and, for the q_attn pool,
    ``mlp/query_attention_step_<step>.ckpt`` (torch state dicts). Every
    rank gathers; ``main`` writes."""
    tower, mlp, q_attn = (sharding.full_state_dict(m, main)
                          for m in (model.dit, model.mlp, model.q_attn))
    if not main:
        return
    ck.save_reference_dir(tower, model.dit_cfg, os.path.join(out_dir, "transformer"), step)
    mlp_dir = os.path.join(out_dir, "mlp")
    os.makedirs(mlp_dir, exist_ok=True)
    torch.save(ck.reward_mlp_to_reference(mlp), os.path.join(mlp_dir, f"mlp_step_{step}.ckpt"))
    if "q_attn" in model.pc.pool:
        torch.save(ck.query_attention_to_reference(q_attn),
                   os.path.join(mlp_dir, f"query_attention_step_{step}.ckpt"))


def run(trainer: Trainer, steps: int) -> List[Dict[str, float]]:
    """``steps`` more steps; returns their metrics."""
    config = trainer.config
    logger = cli.MetricLogger(config, trainer.out_dir, trainer.mesh.is_main)
    dev, mesh = trainer.device, trainer.mesh
    history = []
    for step in range(trainer.step, trainer.step + steps):
        raw = next(trainer.loader)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()
                 if not isinstance(v, list)}
        cli.sync(dev)
        t0 = time.perf_counter()
        trainer.state, m = trainer.step_fn(trainer.state, batch,
                                           common.step_generator(dev, trainer.seed, step))
        cli.sync(dev)
        metrics = {"step": step, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                   "acc": float(m["acc"]), "step_time": time.perf_counter() - t0}
        logger.log(metrics, step, {k: v for k, v in metrics.items() if k != "step"})
        if (step + 1) % 100 == 0:
            health = common.validate_params(trainer.model)
            if not health["finite"]:
                logging.error("NON-FINITE PARAMS: %s", health["bad"][:5])
        if (step + 1) % int(config.train.save_interval) == 0:
            path = os.path.join(trainer.out_dir, f"checkpoint-{step + 1}")
            state = trainer.state
            full = sharding.gather_to_host(state.local_params(), state.params, mesh.is_main)
            opt = (common.gathered_opt_state(state, mesh.is_main)
                   if config.train.get("save_optimizer_state") else None)
            if mesh.is_main:
                ck.save_trainable(path, state.names, full)
                if opt is not None:
                    ck.save_opt_state(path + "-opt", opt)
            if config.train.get("save_reference_artifacts", True):
                export_lrm_artifacts(trainer.model, trainer.out_dir, step + 1, mesh.is_main)
            mesh.barrier()
            logging.info("saved %s", path)
            if trainer.val_dataset is not None:
                for key, val in evaluate(trainer.eval_fn, trainer.val_dataset,
                                         config.eval.timestep, int(config.eval.seed), dev,
                                         int(config.eval.get("batch_size") or 8)).items():
                    # the scalars are the JAX trainer's: the classification metrics
                    scalars = {k: v for k, v in val.items() if k != "mean_reward"}
                    logger.log({"step": step + 1, "val": key, **val}, step + 1, scalars,
                               prefix=f"val_t{key[2:]}")
        history.append(metrics)
    logger.close()
    trainer.step += steps
    return history


def main(argv=None) -> List[Dict[str, float]]:
    return cli.main(build_trainer, run, argv)


if __name__ == "__main__":
    main()
