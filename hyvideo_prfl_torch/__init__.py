"""PyTorch/CUDA port of hyvideo_prfl_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's module names so each counterpart is
easy to find. It imports torch and numpy only. The hot ops each have a
kernel written by hand for sm_90a (sources in ``csrc/``, built at first use
by ``ops/_build.py``) and a plain PyTorch version beside it: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Slice 1 covers t2v serving: the DiT forward (``models/wan_dit.py``), UniPC
sampling (``schedulers/unipc.py``), the batched-CFG pipeline
(``pipelines/pipeline.py``) and the checkpoint converters
(``utils/checkpoint.py``). ``scripts/inference_torch.py`` is its CLI.

Slice 2 covers PRFL training on one GPU: every kernel op is a
``torch.autograd.Function`` whose backward is a kernel too (K4/K5, K7,
K9), the DiT keeps fp32 master weights and checkpoints its blocks, and
``training/`` holds the reward step, the SFT step, the frozen reward model
and the optimizer. ``scripts/train_prfl_torch.py`` is its CLI.
"""

__version__ = "0.1.0"
