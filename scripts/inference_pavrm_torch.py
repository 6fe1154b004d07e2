"""PAVRM reward-model evaluation CLI of the PyTorch port (counterpart of
scripts/inference_pavrm.py).

    python scripts/inference_pavrm_torch.py --config_path configs/infer_pavrm_i2v_720.yaml \
        [--max_samples N] [--device cuda]

Loads the LRM the PAVRM trainer exports (model.lrm_transformer_path, else
model.base_path: a reference checkpoint directory, sliced to the kept
blocks; the heads from model.lrm_mlp_path and model.lrm_query_attention_path;
without a checkpoint the seeded JAX initialisers), scores the labelled val
set (dataset.val_meta_file_list, else meta_file_list) at each eval.timestep
with fixed-seed noise, and prints, per timestep, accuracy, precision,
recall, F1, the timestep's bucket and the mean reward as JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hyvideo_prfl_torch.configs import dit_cfg_from, load_config  # noqa: E402
from hyvideo_prfl_torch.training.pavrm import (  # noqa: E402
    PavrmModel, evaluate, labelled_dataset, make_eval_step, pavrm_config_from,
)

TIMESTEP_BUCKETS = [(0, 200), (201, 400), (401, 600), (601, 800), (801, 1000)]


def load_lrm(config, device) -> PavrmModel:
    """The PavrmModel of a config, with the exported LRM's weights."""
    model = PavrmModel(dit_cfg_from(config), pavrm_config_from(config, loss="ce"),
                       device=device)
    lrm_path = config.model.lrm_transformer_path or config.model.base_path
    if lrm_path and os.path.isdir(lrm_path):
        model.load_reference(lrm_path, config.model.lrm_mlp_path,
                             config.model.lrm_query_attention_path)
    else:
        logging.info("no LRM checkpoint; seeded JAX-initialiser weights")
        model.init_params(torch.Generator(device=device).manual_seed(int(config.eval.seed)))
    return model.eval().requires_grad_(False)


def evaluate_config(config, max_samples=None, device="cuda") -> Dict[str, Dict]:
    """Score the val set of a loaded config: the CLI's work."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (pass --device cpu for a CPU run)")
    model = load_lrm(config, device)
    meta_lists = (list(config.dataset.get("val_meta_file_list") or [])
                  or list(config.dataset.meta_file_list))
    dataset = labelled_dataset(config, model.pc, meta_lists, int(config.eval.seed))
    timesteps = list(config.eval.timestep)
    results = evaluate(make_eval_step(model), dataset, timesteps, int(config.eval.seed), device,
                       batch_size=int(config.eval.get("batch_size") or 8),
                       max_samples=max_samples)
    for t in timesteps:
        bucket = next((b for b in TIMESTEP_BUCKETS if b[0] <= t <= b[1]), None)
        results[f"t={t}"]["bucket"] = str(bucket)
        logging.info("t=%s: %s", t, results[f"t={t}"])
    print(json.dumps(results, indent=2))
    return results


def main(argv=None) -> Dict[str, Dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return evaluate_config(load_config(args.config_path), max_samples=args.max_samples,
                           device=args.device)


if __name__ == "__main__":
    main()
