"""Model-size and resolution registry (hyvideo_prfl_tpu/configs/__init__.py).

The constants are copies, not imports: the JAX package's configs module
imports its flax model, and this package never imports JAX.
"""

import dataclasses

from ..models import wan_dit
from .config import AttrDict, config_from_dict, default_config, load_config

# user-facing size name -> (W, H)
SIZE_CONFIGS = {
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
    "1024*1024": (1024, 1024),
}

MAX_AREA_CONFIGS = {
    "720*1280": 720 * 1280,
    "1280*720": 1280 * 720,
    "480*832": 480 * 832,
    "832*480": 832 * 480,
}

# default negative prompt for CFG sampling (an interop constant: generations
# match the reference only with the same uncond text)
SAMPLE_NEG_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
    "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
    "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)

SUPPORTED_SIZES = {
    "t2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2v-1.3B": ("480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "flf2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2i-14B": tuple(SIZE_CONFIGS.keys()),
}


def dit_config_for_task(task: str, **kw) -> wan_dit.WanConfig:
    """Map a task string (t2v-1.3b, i2v-14b-720p, ...) to a WanConfig, by
    the JAX package's prefixes."""
    t = task.lower()
    if t.startswith("t2v-1.3b"):
        return wan_dit.t2v_1_3b(**kw)
    if t.startswith("t2i"):
        return wan_dit.t2v_14b(**kw)
    if t.startswith("i2v-1.3b"):
        return wan_dit.i2v_1_3b(**kw)
    if t.startswith("t2v-14b"):
        return wan_dit.t2v_14b(**kw)
    if t.startswith("i2v-14b"):
        return wan_dit.i2v_14b(**kw)
    if t.startswith("flf2v"):
        return wan_dit.flf2v_14b(**kw)
    raise ValueError(f"unknown task {task}")


def dit_cfg_from(config) -> wan_dit.WanConfig:
    """A training config's WanConfig: its task's, with
    model.gradient_checkpointing (remat), model.remat_policy and
    model.override applied (scripts/_common.py ``dit_cfg_from``)."""
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


__all__ = [
    "SIZE_CONFIGS", "MAX_AREA_CONFIGS", "SUPPORTED_SIZES",
    "SAMPLE_NEG_PROMPT", "dit_config_for_task", "dit_cfg_from", "AttrDict",
    "config_from_dict", "default_config", "load_config",
]
