"""What the two training CLIs (scripts/train_prfl_torch.py and
scripts/train_pavrm_torch.py) share: the device and the process mesh
(``torchrun --nproc_per_node N``: one process per GPU, NCCL; gloo under
--device cpu), the data stream of a
resumed run, the metrics (rank 0's JSON log lines and TensorBoard
scalars) and the command line."""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from hyvideo_prfl_torch.configs import load_config
from hyvideo_prfl_torch.data.loader import DataParallelLoader
from hyvideo_prfl_torch.parallel import sharding


def exists(path) -> bool:
    return bool(path) and os.path.exists(path)


def start(config, device) -> torch.device:
    """Join the torchrun process group and return this process's device,
    leaving when CUDA is missing (an unknown FSDP strategy fails first)."""
    sharding.fsdp_strategy_from(config)  # an unknown strategy fails before the build
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (pass --device cpu for a CPU run)")
    device = sharding.init_distributed(device)
    if config.train.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
    return device


def mesh_for(config, device) -> sharding.Mesh:
    """The (data, sp) mesh of the process group: sp = min(dataset.sp_size,
    world), Ulysses chunks from train.ulysses_chunks (else
    HYV_ULYSSES_CHUNKS)."""
    chunks = config.get_path("train.ulysses_chunks")
    return sharding.build_mesh(int(config.get_path("dataset.sp_size", 1) or 1), device,
                               chunks=int(chunks) if chunks else None)


def make_loader(dataset, config, seed: int, start_step: int,
                mesh: sharding.Mesh = sharding.Mesh()):
    """This data replica's batch stream of a run that starts at
    ``start_step``, one batch a step, read two batches ahead on a
    background thread: the steps before it are replayed and dropped, so a
    resumed run reads and draws what an uninterrupted one does."""
    return iter(DataParallelLoader(
        dataset, mesh.data, mesh.data_rank, batch_size=config.dataset.batch_size,
        shuffle=bool(config.dataset.get("shuffle")), seed=seed, skip_batches=start_step,
        prefetch=2, sp_size=mesh.sp))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MetricLogger:
    """Rank 0's metrics: one JSON line a record to stdout and to
    ``<save.log_dir or out_dir/logs>/log.txt``, and TensorBoard scalars in
    the same directory where ``torch.utils.tensorboard`` imports (the JAX
    MetricLogger's tags: ``<prefix>/<key>``, ``train`` for the steps and
    ``val_t<t>`` for an evaluation). Without TensorBoard it logs one line
    and keeps to the text, as the JAX logger does; other ranks write
    nothing."""

    def __init__(self, config, out_dir: str, main: bool = True):
        self.main, self.writer = main, None
        log_dir = config.save.log_dir or os.path.join(out_dir, "logs")
        self.path = os.path.join(log_dir, "log.txt")
        if not main:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logging.info("tensorboard unavailable; logging to text only")
            return
        self.writer = SummaryWriter(log_dir)

    def log(self, record, step: int, scalars, prefix: str = "train") -> None:
        """``record`` as a JSON line; ``scalars`` ({key: number}) as the
        scalars ``<prefix>/<key>`` at ``step``."""
        if not self.main:
            return
        line = json.dumps(record)
        print(line, flush=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
        if self.writer is not None:
            # the writer flushes on its own timer and in close()
            for key, value in scalars.items():
                self.writer.add_scalar(f"{prefix}/{key}", float(value), step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.writer = None


def main(build_trainer, run, argv=None):
    """--config_path, --max_steps, --device: train up to step max_steps
    (optimizer.max_train_steps without it; a resumed run continues from
    its step)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = load_config(args.config_path)
    # the reference trainer's switch; PyTorch's default runs cuDNN's fp32
    # convolutions (the VAE's sanity decode) in TF32
    tf32 = bool(config.train.get("allow_tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    trainer = build_trainer(config, args.device)
    total = args.max_steps or int(config.optimizer.max_train_steps)
    return run(trainer, max(0, total - trainer.step))
