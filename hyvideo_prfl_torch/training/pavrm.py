"""PAVRM, the latent reward model and its trainer
(hyvideo_prfl_tpu/training/pavrm.py).

``PavrmModel`` is the first ``max(feature_layer)`` blocks of the DiT with no
head, a QueryAttention pool and a RewardMLP; ``score`` maps noisy latents
to reward logits. PRFL holds it frozen; the PAVRM trainer trains the kept
blocks and both heads (fp32 masters) with the embeddings frozen.

Objectives (``PavrmConfig.loss``):

* "ce": BCE of ``sigmoid(logits)`` against the binary quality label;
* "bt": Bradley-Terry, BCE of ``sigmoid(r_win - r_lose)`` against ones.
  Both sides take the same noise and the same t, as the JAX step draws
  both from one key.

The timestep is a fixed list cycled by the optimizer step, or a draw from
the flow-matching schedule (logit-normal or uniform). The step takes its
draws (``t``, ``noise``) injected, so a test can hand it another
framework's, or draws them from a ``torch.Generator``. The finite guard is
the JAX package's: a non-finite loss or gradient zeroes every gradient and
logs loss 0, and the AdamW update still runs.

On a process mesh (``mesh``) every rank draws the global batch's ``t``
and ``noise`` and keeps its data replica's rows (an injected draw is the
global batch's too); the tower splits the tokens over the sp ranks and
gathers the feature taps, so the pool sees every token. The logged loss
and accuracy are the means over the data replicas; the finite guard
holds when the mean loss and every rank's gradient shards are finite.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.dataset import LatentCacheDataset
from ..models import reward as rw
from ..models import wan_dit
from ..parallel import sharding
from ..schedulers import flow_match as fm
from ..utils import checkpoint as ck
from . import common


@dataclasses.dataclass(frozen=True)
class PavrmConfig:
    """The lrm.* and scheduler fields (configs/train_pavrm_*.yaml)."""

    loss: str = "ce"  # ce | bt
    pool: str = "q_attn"  # q_attn | mean | max
    feature_layer: Tuple[int, ...] = (8,)
    trainable_blocks: Tuple[int, ...] = tuple(range(8))
    num_queries: int = 1
    num_heads: int = 8
    return_type: Optional[str] = "query"
    # timestep selection: a fixed list cycled by the step, or None: sampled
    timesteps: Optional[Tuple[int, ...]] = None
    weighting_scheme: str = "logit_normal"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    num_train_timesteps: int = 1000
    task: str = "t2v"  # governs the conditioning inputs

    @property
    def is_i2v(self) -> bool:
        return "i2v" in self.task or "flf2v" in self.task

    @property
    def is_flf2v(self) -> bool:
        return "flf2v" in self.task


def pavrm_config_from(config, loss: Optional[str] = None) -> PavrmConfig:
    """A training config's lrm.* and extra_model.scheduler.* (``loss``
    overrides lrm.loss)."""
    lrm, sched = config.lrm, config.extra_model.scheduler
    return PavrmConfig(
        loss=loss or lrm.loss, pool=lrm.pool, feature_layer=tuple(lrm.feature_layer),
        trainable_blocks=tuple(lrm.trainable_blocks),
        num_queries=lrm.query_attention.num_queries, num_heads=lrm.query_attention.num_heads,
        return_type=lrm.query_attention.return_type,
        timesteps=tuple(lrm.timestep) if lrm.get("timestep") else None,
        weighting_scheme=sched.weighting_scheme, logit_mean=float(sched.logit_mean),
        logit_std=float(sched.logit_std), num_train_timesteps=int(sched.num_train_timesteps),
        task=config.task)


def labelled_dataset(config, pc: PavrmConfig, meta_lists, seed: int,
                     dataset_type: str = "lrm_ce", lose_lists=()) -> LatentCacheDataset:
    """The reward model's dataset of a training config: labels from
    lrm.task, lose pairs (lrm_bt_online) from ``lose_lists``."""
    return LatentCacheDataset(
        meta_file_list=list(meta_lists), meta_file_lose_list=list(lose_lists),
        uncond_prob=list(config.dataset.uncond_prob),
        text_len=config.extra_model.get_path("text_encoder.t5_text_len", 512),
        null_dir=config.dataset.null_dir, is_i2v=pc.is_i2v, is_flf2v=pc.is_flf2v,
        seed=seed, dataset_type=dataset_type, label_key=config.lrm.task)


def trimmed_config(cfg: wan_dit.WanConfig, num_blocks: int) -> wan_dit.WanConfig:
    return dataclasses.replace(cfg, num_layers=num_blocks)


class PavrmModel(nn.Module):
    """Trimmed head-less DiT + QueryAttention pool + RewardMLP.

    ``param_dtype`` stores the tower's dense weights: the compute dtype for
    the frozen LRM of PRFL, fp32 masters for the trainer, which then calls
    ``freeze_embeddings`` so that only the blocks and the heads train."""

    def __init__(self, dit_cfg: wan_dit.WanConfig, pc: PavrmConfig, device=None,
                 param_dtype=None):
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
        self.dit = wan_dit.WanModel(self.dit_cfg, device=device, param_dtype=param_dtype,
                                    with_head=False)
        self.q_attn = rw.QueryAttention(dit_cfg.dim, pc.num_queries, pc.num_heads,
                                        pc.return_type, device=device)
        self.mlp = rw.RewardMLP(dit_cfg.dim, device=device)

    def init_params(self, generator: torch.Generator):
        """The JAX initialisers for the tower and both heads."""
        wan_dit.init_params(self.dit, generator)
        self.q_attn.init_params(generator)
        self.mlp.init_params(generator)
        return self

    def load_reference(self, tower_path: str, mlp_path: str,
                       query_attention_path: Optional[str] = None):
        """Weights from the reference layout (the PAVRM export, or a whole
        released transformer): the tower's first blocks from a checkpoint
        directory, the heads from their torch state dicts (the pool's only
        for the q_attn pool)."""
        self.dit.load_state_dict(ck.load_tower_dir(tower_path, self.dit_cfg,
                                                   self.dit_cfg.num_layers))
        self.mlp.load_state_dict(ck.load_reward_head(mlp_path, "mlp"))
        if self.pc.pool == "q_attn":
            self.q_attn.load_state_dict(ck.load_reward_head(query_attention_path, "qattn"))
        return self

    def parallelize(self, mesh: sharding.Mesh, strategy: str = "full") -> sharding.Layout:
        """The mesh's sp group for the tower; the tower (each WanBlock,
        then the DiT) and both heads sharded under ``strategy``."""
        sharding.set_sequence_parallel(self.dit, mesh.seq())
        return sharding.shard_model(mesh, [self.dit, self.q_attn, self.mlp], strategy,
                                    self.dit.blocks)

    def freeze_embeddings(self):
        """Only the blocks and the heads train: every other tower parameter
        (patch, text and time embeddings, the i2v img_emb) is frozen."""
        for name, p in self.dit.named_parameters():
            p.requires_grad_(name.startswith("blocks."))
        return self

    def score(self, noisy_latents, t, text, y=None, clip_fea=None, grid=None):
        """Noisy latents (video, or token cells with ``grid``; ``y`` in the
        same layout, and ``clip_fea``, for i2v/flf2v) -> reward logits
        [B, 1] (pre-sigmoid)."""
        feats = self.dit(noisy_latents, t, text, y=y, clip_fea=clip_fea, grid=grid,
                         output_features=True, selected_layers=self.pc.feature_layer)
        pooled = rw.pool_features(feats, self.pc.pool, self.q_attn)
        return self.mlp(pooled)


def select_timestep(pc: PavrmConfig, schedule: fm.FlowMatchSchedule, step: int,
                    batch_size: int, generator: Optional[torch.Generator] = None):
    """The fixed list's entry ``step % len`` for the whole batch, or a draw
    from the schedule -> (t [B], sigma [B]) fp32 on the CPU."""
    if pc.timesteps is not None:
        t = torch.full((batch_size,), float(pc.timesteps[step % len(pc.timesteps)]))
        return t, fm.sigma_for_timestep(schedule, t)
    return fm.sample_train_timestep(schedule, batch_size, pc.weighting_scheme,
                                    pc.logit_mean, pc.logit_std, generator=generator)


def make_train_step(model: PavrmModel, tx: common.Optimizer, schedule: fm.FlowMatchSchedule,
                    mesh: Optional[sharding.Mesh] = None):
    """The PAVRM step: step(state, batch, generator=None, t=None, noise=None)
    -> (state, metrics). ``t`` ([B] timesteps; sigma is the schedule's at
    t) and ``noise`` (the latents' shape) replace the step's draws."""
    pc = model.pc
    mesh = mesh or sharding.Mesh()

    def step(state: common.TrainState, batch, generator=None, t=None, noise=None):
        latents = batch["latents"]
        b, dev = latents.shape[0] * mesh.data, latents.device
        if t is None:
            t, sigma = select_timestep(pc, schedule, state.step, b, generator)
        else:
            t = torch.as_tensor(t, dtype=torch.float32).cpu().reshape(b)
            sigma = fm.sigma_for_timestep(schedule, t)
        if noise is None:
            noise = torch.randn((b, *latents.shape[1:]), generator=generator,
                                dtype=torch.float32, device=dev)
        t, noise = mesh.rows(t).to(dev), mesh.rows(noise).to(dev, torch.float32)
        sig5 = mesh.rows(sigma).to(dev).reshape(-1, 1, 1, 1, 1)
        clip_fea = common.reshape_clip(batch.get("clip_fea")) if pc.is_i2v else None

        def score(lat, cond_key):
            y = common.i2v_condition(batch.get(cond_key), pc.is_flf2v) if pc.is_i2v else None
            return model.score(fm.add_noise(lat, noise, sig5), t, batch["text"], y=y,
                               clip_fea=clip_fea)

        if pc.loss == "ce":
            probs = rw.reward_sigmoid(score(latents, "cond"))[:, 0]
            labels = batch["labels"].float()
            loss = rw.bce_loss(probs, labels)
            acc = ((probs > 0.5) == (labels > 0.5)).float().mean()
        elif pc.loss == "bt":
            probs = rw.siamese_prob(score(latents, "cond"),
                                    score(batch["latents_lose"], "cond_lose"))[:, 0]
            loss = rw.bce_loss(probs, torch.ones_like(probs))
            acc = (probs > 0.5).float().mean()
        else:
            raise ValueError(f"unknown PAVRM loss {pc.loss!r}")
        loss.backward()
        # the finite guard: the loss and every gradient
        loss = mesh.mean_over_data(loss.detach())
        finite = mesh.all_true(torch.stack([torch.isfinite(loss)] + [
            torch.isfinite(sharding.local(p.grad)).all()
            for p in state.params if p.grad is not None]).all())
        grads = common.collect_grads(state, finite)
        state, gnorm = common.apply_grads(state, tx, grads)
        return state, {"loss": loss if finite else torch.zeros_like(loss),
                       "grad_norm": gnorm, "acc": mesh.mean_over_data(acc.detach()),
                       "probs": probs.detach()}

    return step


def make_eval_step(model: PavrmModel):
    """The fixed-seed eval forward: eval_step(batch, t_value, seed=0,
    noise=None) -> probs [B]. The noise comes from a generator seeded with
    ``seed`` on the batch's device, or is injected; sigma is
    t / num_train_timesteps, as in the JAX eval."""
    pc = model.pc

    @torch.no_grad()
    def eval_step(batch, t_value: float, seed: int = 0, noise=None):
        latents = batch["latents"]
        b, dev = latents.shape[0], latents.device
        if noise is None:
            noise = torch.randn(latents.shape, dtype=torch.float32, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(int(seed)))
        t = torch.full((b,), float(t_value), device=dev)
        noisy = fm.add_noise(latents, noise.to(dev, torch.float32),
                             float(t_value) / pc.num_train_timesteps)
        y, clip_fea = common.prepare_conditioning(batch, pc.is_i2v, pc.is_flf2v)
        logits = model.score(noisy, t, batch["text"], y=y, clip_fea=clip_fea)
        return rw.reward_sigmoid(logits)[:, 0]

    return eval_step


def classification_metrics(probs: np.ndarray, labels: np.ndarray,
                           threshold: float = 0.5) -> Dict[str, float]:
    """accuracy, precision, recall and F1 (sklearn's definitions)."""
    pred = (np.asarray(probs) > threshold).astype(np.int32)
    y = np.asarray(labels).astype(np.int32)
    tp = int(((pred == 1) & (y == 1)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    acc = float((pred == y).mean()) if len(y) else 0.0
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1}


def batched_eval(eval_step, dataset, timesteps, seed: int, device, batch_size: int = 8,
                 max_samples: Optional[int] = None) -> Dict[float, Tuple[List, List]]:
    """Shape-bucketed eval over a labelled dataset (scripts/_common.py
    ``batched_eval``): one pass over the data, samples grouped into
    same-shape batches of ``batch_size`` (the last one padded with copies
    of its last sample when a bucket holds more than one batch), one call
    per batch and timestep. Returns {float(t): (probs, labels)}."""
    n = min(len(dataset), max_samples or len(dataset))
    buckets: Dict[tuple, list] = {}
    for i in range(n):
        s = dataset[i]
        buckets.setdefault(tuple(np.asarray(s["latents"]).shape), []).append(s)
    out = {float(t): ([], []) for t in timesteps}
    for samples in buckets.values():
        for j in range(0, len(samples), batch_size):
            chunk = samples[j:j + batch_size]
            nb = len(chunk)
            pad = batch_size - nb if len(samples) > batch_size else 0

            def stack(k):
                arr = np.stack([np.asarray(s[k]) for s in chunk])
                if pad:
                    arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
                return torch.from_numpy(arr).to(device)

            batch = {k: stack(k) for k in chunk[0]
                     if not isinstance(chunk[0][k], str) and k != "labels"}
            labels = [float(s["labels"]) for s in chunk]
            for t in timesteps:
                probs, labs = out[float(t)]
                probs.extend(eval_step(batch, float(t), int(seed))[:nb].float().cpu().tolist())
                labs.extend(labels)
    return out


def evaluate(eval_step, dataset, timesteps, seed: int, device, batch_size: int = 8,
             max_samples: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """batched_eval's probabilities -> {"t=<t>": classification metrics and
    the mean reward} per timestep. The dataset's draws (captions) restart
    from ``seed`` too, so every evaluation scores the same inputs."""
    dataset.rng.seed(seed)
    per_t = batched_eval(eval_step, dataset, list(timesteps), seed, device,
                         batch_size=batch_size, max_samples=max_samples)
    out = {}
    for t in timesteps:
        probs, labels = per_t[float(t)]
        out[f"t={t}"] = {**classification_metrics(probs, labels),
                         "mean_reward": float(sum(probs) / max(len(probs), 1))}
    return out
