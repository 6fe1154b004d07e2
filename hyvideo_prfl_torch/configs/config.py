"""YAML config loader (hyvideo_prfl_tpu/configs/config.py, copied: that
package's configs module imports JAX).

The same YAML files load unchanged, with attribute-style access
(cfg.model.lora.use_lora), including the reference's misspelled key
`fsdp_sharding_startegy` [sic]. ``load_config`` reads the file with the
port's own reader (``yaml_lite``: the subset the configs use, typed as
``yaml.safe_load`` types it), so no pyyaml is needed; ``config_from_dict``
is the same merge without a file.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from . import yaml_lite


class AttrDict(dict):
    """dict with attribute access, recursively (OmegaConf-lite)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, path: str, default=None):
        cur: Any = self
        for part in path.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj


# task name -> model family (NAME_MAPPING, train_prfl.py:86-93)
NAME_MAPPING = {
    "t2v-1.3b": "wanx",
    "i2v-1.3b": "wanx",
    "t2v-14b": "wanx",
    "i2v-14b-480p": "wanx",
    "i2v-14b-720p": "wanx",
    "flf2v-14b-720p": "wanx",
}


_DEFAULTS: Dict[str, Any] = {
    "train_id": "run",
    "task": "t2v-1.3b",
    "model": {
        "base_path": None,
        "init_transformer_path": None,
        "lrm_transformer_path": None,
        "lrm_mlp_path": None,
        "lrm_query_attention_path": None,
        "resume_transformer_path": None,
        "patch_size": [1, 2, 2],
        "lora": {
            "use_lora": False, "lora_rank": 128,
            "target_modules": ["q", "k", "v", "o"], "resume_lora_path": None,
        },
        "ema": {"use_ema": False, "ema_decay": 0.99},
        "fsdp": {"fsdp_sharding_startegy": "full", "use_cpu_offload": False},
        "gradient_checkpointing": True,
        "selective_checkpointing": 1.0,
    },
    "extra_model": {
        "vae": {"name": "Wan2.1_VAE.pth", "vae_stride": [4, 8, 8]},
        "text_encoder": {
            "t5_text_len": 512,
            "t5_checkpoint": "models_t5_umt5-xxl-enc-bf16.pth",
            "t5_tokenizer": "google/umt5-xxl",
        },
        "image_encoder": {
            "clip_checkpoint": "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth",
            "clip_tokenizer": "xlm-roberta-large",
        },
        "scheduler": {
            "flow_shift": 5.0, "num_train_timesteps": 1000,
            "weighting_scheme": "uniform", "logit_mean": 0, "logit_std": 1,
            "mode_scale": 1.29,
        },
    },
    "dataset": {
        "meta_file_list": [], "meta_file_lose_list": [],
        "null_dir": None,
        "val_meta_file_list": [],
        "crop_ratio": [1, 1, 1], "crop_type": "random",
        "uncond_prob": [0.0, 0.0], "sp_size": 1, "batch_size": 1,
        "sp_batch_size": 1, "num_workers": 4, "group_frame": None,
        "group_resolution": None,
    },
    "optimizer": {
        "learning_rate": 5e-6, "learning_rate_mlp": None,
        "adam_beta1": 0.9, "adam_beta2": 0.999, "adam_epsilon": 1e-8,
        "weight_decay": 0.01, "lr_scheduler": "constant",
        "lr_warmup_steps": 0, "lr_num_cycles": 1, "lr_power": 1.0,
        "max_train_steps": 1_000_000,
    },
    "train": {
        "seed": 42, "precision": "bf16", "extra_precision": "bf16",
        "allow_tf32": False, "save_interval": 100,
        "sanity_check_interval": 100, "teacher_student_parallel": False,
        "dpo_beta": 500, "gradient_accumulation_steps": 1,
    },
    "save": {"output_dir": "outputs", "log_dir": None,
             "sanity_check_dir": None},
    "eval": {"seed": 42, "timestep": [100, 300, 500, 700, 900]},
    "lrm": {
        "query_attention": {
            "num_queries": 1, "num_heads": 8, "dropout": 0.0,
            "return_type": "query",
        },
        "feature_layer": [8], "pool": "q_attn", "mlp_dim": 5120,
        "loss": "ce", "task": "motion_quality",
        "trainable_blocks": [0, 1, 2, 3, 4, 5, 6, 7],
        "timestep": None,
    },
}


def _merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


_SCI_FLOAT = __import__("re").compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")


def _coerce_numbers(obj):
    """pyyaml parses '1e-3' (no dot) as a string; OmegaConf coerces it.
    Match that behavior for unambiguous scientific-notation literals."""
    if isinstance(obj, dict):
        return {k: _coerce_numbers(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_coerce_numbers(v) for v in obj]
    if isinstance(obj, str) and _SCI_FLOAT.match(obj):
        return float(obj)
    return obj


def config_from_dict(raw: Dict) -> AttrDict:
    """A config from a parsed YAML tree, merged over the defaults."""
    cfg = AttrDict.wrap(_merge(_DEFAULTS, _coerce_numbers(raw or {})))
    # normalized float coercions the reference tolerates (e.g. "5." steps)
    cfg["train"]["gradient_accumulation_steps"] = int(
        float(cfg["train"]["gradient_accumulation_steps"])
    )
    return cfg


def load_config(path: str) -> AttrDict:
    return config_from_dict(yaml_lite.load(path))


def default_config() -> AttrDict:
    return AttrDict.wrap(copy.deepcopy(_DEFAULTS))
