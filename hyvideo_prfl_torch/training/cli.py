"""What the two training CLIs (scripts/train_prfl_torch.py and
scripts/train_pavrm_torch.py) share: the refusal of the options the port
lacks, the device, the data stream of a resumed run, the JSON log lines
and the command line."""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from hyvideo_prfl_torch.configs import load_config
from hyvideo_prfl_torch.data.loader import BatchIterator, BlockDistributedSampler


def exists(path) -> bool:
    return bool(path) and os.path.exists(path)


def start(config, device, **asks) -> torch.device:
    """Raise NotImplementedError for a config option the port lacks (the
    shared ones and ``asks``: {description: whether the config asks for
    it}), then return the device, leaving when CUDA is missing."""
    asks = {
        "multi-device training (dataset.sp_size > 1)":
            int(config.get_path("dataset.sp_size", 1) or 1) > 1,
        "optimizer-state offload (model.fsdp.use_cpu_offload, train.offload_opt_state)":
            config.get_path("model.fsdp.use_cpu_offload")
            or config.get_path("train.offload_opt_state"),
        **asks,
    }
    missing = [name for name, on in asks.items() if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {'; '.join(missing)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (pass --device cpu for a CPU run)")
    if config.train.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
    return device


def make_loader(dataset, config, seed: int, start_step: int):
    """The batch stream of a run that starts at ``start_step``, one batch a
    step, read two batches ahead on a background thread: the steps before
    it are replayed and dropped, so a resumed run reads and draws what an
    uninterrupted one does."""
    sampler = BlockDistributedSampler(len(dataset), shuffle=bool(config.dataset.get("shuffle")),
                                      seed=seed)
    return iter(BatchIterator(dataset, sampler, batch_size=config.dataset.batch_size,
                              skip_batches=start_step, prefetch=2))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log_path(config, out_dir: str) -> str:
    """<save.log_dir or out_dir/logs>/log.txt, its directories made."""
    os.makedirs(out_dir, exist_ok=True)
    log_dir = config.save.log_dir or os.path.join(out_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, "log.txt")


def log_line(path: str, record) -> None:
    """One JSON line to stdout and to the log file."""
    line = json.dumps(record)
    print(line, flush=True)
    with open(path, "a") as f:
        f.write(line + "\n")


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
