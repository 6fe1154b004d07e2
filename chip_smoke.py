#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hyvideo_prfl_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Print the card's name and power limit; build the Hopper kernels from
   hyvideo_prfl_torch/csrc (one nvcc per source, all at once) and print the
   build time, each slice kernel's registers and spills (K1-K5, K3s, K7,
   K9, K10, the probes and the norm kernels' wide instances must have
   none),
   the shared memory of the forward, K4, K5's dq pass and K10, and the
   warpgroup MMA and TMA load instructions in the
   disassembly of K1, K2, K3, K3s, K4, both K5 passes (HGMMA, UTMALDG), K10
   and the int8 probe (IGMMA, UTMALDG), the bf16 probe (HGMMA, UTMALDG),
   K7 (UTMALDG; K7 and the probes without global atomics) and K9's two
   instances (UBLKCP, the bulk copies of its ring): all must be there.
   K5's dk/dv kernel must keep the registers and SASS instruction count
   of the kernel its PERF.md time was measured on.
2. Hold each forward kernel (K8 ln_scale_shift, K6 qk-norm+rope, K1
   streaming and K3 single-block flash forward, K10 int8-score flash
   forward) against its plain PyTorch version at the t2v-1.3B 832*480
   81-frame CFG-2 shapes, with a stated bound, K10 also against K1, and
   time each with CUDA events, in turns with its plain version and, where
   one PyTorch call computes the same function, that call (K10 in turns
   with K1). K1 and K3
   (both TMA/wgmma instances of flash_fwd.cu) print TFLOP/s and their
   share of the bound; K3 is timed over 20 calls a turn, in turns also
   with the streaming form at the same 512 keys (streaming_ms).
   2b. The same for the shifted forward K2 (also against K1, with a user
   key mask, and at logits near 300, where K1 overflows), its single-block
   form K3s at the cross-attention shape (timed as K3, in turns with K3,
   SDPA and the shifted streaming form), and the rope R forward and
   backward (bit for bit).
3. Whole-model check: WanModel at t2v-1.3B width with 1 block (cut from
   2 for phase 17's room) on the
   9-frame grid (4,680 tokens), seeded weights with a non-zero head, loaded
   through utils/checkpoint.from_jax_params, on the card against the same
   module on the CPU (which runs the plain versions); then the same for
   the int8 model (W8A8 block matmuls and the int8 self-attention, K10).
4. Serve through the CLI path (scripts/inference_torch.py) at t2v-1.3B
   full width and depth, 832*480, CFG 5.0: two 21-frame requests with 4
   UniPC steps and one 81-frame request with 2 steps in bf16, the 81-frame
   one again on the shifted route (HYV_FLASH_BOUNDED=0: K2 and K3s, no
   K1/K3), then the first and the last again under --quant int8
   --quant_attn int8. Latents must be finite and of the expected shape,
   every kernel's launch count must match the number of DiT forwards, and
   the shifted and int8 latents must lie near the bf16 ones of the same
   seed.
5. Hold each backward kernel (K4 merged and K5 split flash backward, K7
   qk-norm+rope backward, K9 LayerNorm+modulate backward) against its
   plain PyTorch version at the training shapes (81 frames, batch 1), with
   a stated bound, and time each with its plain version and, for K4/K5,
   the flash backward of PyTorch's scaled_dot_product_attention, and K9
   (dx, ds and dt bitwise equal on a second call, with either cotangent)
   in turns with F.layer_norm's autograd backward, its function at batch
   1 (and K8's fp32-out instance with F.layer_norm: d1536_*; K9 must not
   be the slower); K4 at
   the self-attention and at the text cross-attention (lk 512: cross_*);
   K5 at the self-attention (in turns with K4 too, as k4_ms) and at lq
   1,024 (short_q_*: the split route through the autograd op, the dq
   pass's key range split as the wrapper picks it, and unsplit as
   short_q_unsplit_ms); then K4 and K5 in turns at every shape the
   training paths hand K4 (K4_SHAPES: the self-attention, the 512 text and
   257 image keys, 12k, the sp4 shard and a ring hop; turns_<shape>_ms),
   K5's self-attention time printed beside its PERF.md time (K5_SELF_MS).
   5b. K4 and K5 with a key mask: within their bound, masked keys'
   gradients exactly 0.
6. Whole-model gradient check: the 2-block full-width WanModel (fp32
   masters, remat "attn") on the 9-frame grid, loss = sum(out * r), the
   output (phase 3's bound) and every parameter's and the input's
   gradient on the card against the CPU's
   (a CPU run at fp32 compute measures each gradient's bf16 noise), with
   each backward kernel's launch count equal to its derivation.
7. Train through the CLI path (scripts/train_prfl_torch.py) on a seeded
   latent cache: configs/train_prfl_t2v_480.yaml as load_config reads it,
   changed to t2v-1.3B (8 PRFL steps, fixed_mid 3, no accumulation, no
   weights; remat "attn" as published), two outer steps at
   21 frames and one at 81; then, from the same weights and draws, one at
   21 and one at 81 with train.rollout_quant int8, one at 21 on the
   shifted route, and one at 21 with every backward on K5
   (HYV_FLASH_MERGED_BWD=0). Metrics finite, grad norm above 0, the
   policy's blocks moved, launch counts per outer step equal to the
   derivation (expected_train_launches), the int8 run's first reward
   within 0.05, the shifted and the split-backward runs' within 0.01 of
   the bf16 run's; prints seconds per refl and SFT step and the peak device
   memory.
8. The int8 probes P1 and P2 through their scripts
   (scripts/probe_int8_{rate,mosaic}_torch.py): wgmma int8 against bf16,
   the reps split over a thread-block cluster; exact against their plain
   versions, int8 and bf16 TOPS beside torch._int_mm's and torch.matmul's.
9. The un-normed DiT (qk_norm off, the shifted route by nature, R for its
   rope): 1 block (cut from 2; no norm3) card against CPU, output and every
   gradient, as phases 3 and 6; then 30 blocks at 81 frames, one
   batched-CFG forward through the pipeline, latents finite and the R,
   K2 and K3s launches as derived.
10. The 14B width: K6-K9 against their plain versions at [1, 75,600, 5120]
   with 40 heads (t2v-14B at 720*1280, 81 frames; the norm kernels' wide
   row layout) and at [1, 3,120, 1280] with 10 heads (bench.py's shape),
   timed beside their byte bounds, K7 and K9 bitwise equal on a second
   call, K8 (fp32 out) and K9 in turns with F.layer_norm and its backward
   (K9 must not be the slower); K1 and
   K2 against their plain versions at the 14B self-attention's
   sequence-parallel shards (40 heads x 18,900 tokens; 10 and 5 heads x
   75,600), timed beside SDPA's flash forward; a 1-block t2v-14B model,
   output and every gradient card against CPU at one
   latent frame of 832*480 (1,560 tokens), as phases 3 and 6; the same
   block forward and backward at 720*1280 and 81 frames on the card,
   gradients finite and launches as derived, with seconds and peak memory.
11. i2v and flf2v: K3 at the image cross-attention (2 x 40 heads x 32,760
   queries over 257 CLIP keys for i2v and 514 for flf2v), K10 at the
   i2v-14B int8 self-attention (2 x 40 x 9,360; in turns with K1) and K4 at
   the
   i2v-1.3B training shape (12 heads, 9,360 x 257) against their plain
   versions, timed beside SDPA and their bounds; 1 i2v-14B block card
   against CPU at 1,560 tokens, output and every gradient (the image
   branch's and the inputs y and clip_fea included), and 2 flf2v-14B blocks,
   output; then i2v-14B and flf2v-14B at full width and depth (40 blocks,
   dim 5120) served through scripts/inference_torch.py at 832*480, CFG
   5.0, 2 UniPC steps: i2v one 81-frame and two 21-frame requests (same
   seed and text, another image: their latents must differ), the first
   21-frame one again under --quant int8 --quant_attn int8 (within 0.3
   relative L2 of bf16), flf2v one 21-frame request; latents finite, each
   kernel's launches as derived (dit_launches(..., i2v=True)), s/step and
   peak memory per request, each pipeline freed before the next is built;
   then one i2v PRFL outer step at i2v-1.3B, 21 frames, through
   scripts/train_prfl_torch.py (configs/train_prfl_i2v_480.yaml as read,
   with phase 7's changes, on a seeded cache with f1_black_path and
   imgclip_path): metrics finite,
   the policy's blocks, img_emb and k_img moved, launches as derived
   (expected_train_launches(..., i2v=True)).
12. PAVRM. First K1 and K3 (o, lse) and K4 and K5 (dq, dk, dv; K5's
   bitwise equal on a second call) at 40 heads x 32,760 queries over the
   32,760 self-attention keys and the 512 text keys, and K6-K9 at [1,
   32,760, 5120] as in phase 10, against their plain versions and timed
   beside their bounds (the tile counts of 12a's persistent grids). Then
   through scripts/train_pavrm_torch.py, each run on a seeded labelled
   cache with the counters set to 0 just before, each config read from
   configs/ by load_config with no weights: (a) the published
   train_pavrm_t2v_480.yaml at t2v-14B width, its 8 blocks, 81
   frames at 832*480 (32,760 tokens), batch 1, remat "attn", 3 ce steps
   over the t list, with s/step, peak memory, the kept blocks and heads
   moved, the embeddings not, launches as derived
   (expected_pavrm_launches); (b) its i2v-14B Bradley-Terry form runs in
   phase 16a; (c) one
   ce step of 1 t2v-14B block (cut from 2) with the heads at 1,560 tokens, the loss and
   every gradient card against CPU at phases 3 and 6's bounds; (d) the
   handoff at t2v-1.3B width: 2 PAVRM steps export the LRM, which
   scripts/inference_pavrm_torch.py's main scores from a --config_path
   that the phase writes as YAML, as the trained model does (its logits
   equal the trained tower's bit for bit), the PRFL trainer (policy
   cut to 8 blocks) loads it and trains 2 outer steps with EMA and the
   optimizer state saved, then one more; a trainer resumed from
   checkpoint-2 repeats that step, its weights and its EMA bit for bit (on
   the split backward, whose dq is deterministic; every sample draws a
   caption and a text drop, and the resumed step lies in the shuffle's
   second epoch).
13. The VAE, umT5-XXL and the CLIP tower (plain PyTorch: no TPU kernel
   runs in them), with seeded weights written in the reference layout:
   (a) the published Wan2.1 VAE (VAEConfig(): dim 96, z 16), loaded
   through utils/encoders.load_reference_vae from a seeded file, card
   against CPU at 5 frames of 64 x 64 (encode and decode, whole-clip and
   streaming), then streaming against whole-clip on the card at 9; (b) an
   81-frame decode at 832*480 ([1, 21, 60, 104, 16] latents, one latent
   frame a step, the frames moved to the host per chunk) in fp32 and in
   bf16, and the 21-frame streaming encode of an i2v conditioning video,
   each timed with its peak memory, frames finite in [-1, 1]; (c)
   umT5-XXL (dim 4096, 64 heads, ffn 10,240, vocab 256,384): 2 layers
   card against CPU on seeded ids with a padded mask, then all 24 on the
   card for two 512-token prompts through the serving CLI's TextEncoder
   (a stub tokenizer: no tokenizer files exist), each context its tokens
   then zeros; (d) CLIP ViT-H/14: 2 blocks card against CPU (the bicubic
   resize too), then all 32 on two frames; (e) inference_torch.main for
   t2v-1.3B, 21 frames, 2 steps, --vae_path: frames [21, 480, 832, 3]
   uint8 written, launches as derived; then one i2v-14B request from a
   seeded image array: Conditioner.condition (CLIP and the VAE's
   streaming encode), the 40-block DiT on (c)'s contexts (launches as
   phase 11's), the decode, with the peak memory from the request to its
   frames; (f) one PRFL outer step of phase 7's run with
   extra_model.vae.params_path and sanity_check_interval 1: launches as
   derived, decoded sanity frames written.
14. The rest of the serving CLI: (a) 2 t2v-1.3B blocks at full width, one
   latent frame of 832*480 (1,560 tokens), seeded, card against CPU:
   dpm++ 3 steps, euler 2 and TeaCache 8 UniPC steps (the threshold
   picked from the CPU gate, at least 1e-3 from every sum it is compared
   with; the skip pattern equal on both sides, at least one interior step
   skipped), within 0.02 relative L2; then two rank-128 LoRAs (kohya,
   transformer) merged on the card, equal bit for bit to the same merged
   in the reference layout and loaded through from_reference_state; (b)
   t2v-1.3B at 30 blocks, 81 frames, through the CLI's pipeline: UniPC,
   dpm++ and euler, 3 steps each, launches as derived, s/step; (c)
   t2i-14B at 40 blocks (frame_num forced to 1): two seeded rank-128 LoRAs
   written as files (kohya .safetensors for --lora_path, transformer .pt
   for --distill_lora_path) and merged by build_pipeline, every merged
   attention weight equal bit for bit to the merge in the reference
   layout; TeaCache over 10 UniPC steps with the t2v-14b coefficients (the
   card's skips equal the CPU gate's, first and last computed), launches
   per computed and skipped step, the published VAE's decode written as a
   PNG; (d) inference_torch.main over two txt records (--prompt_file,
   --save_folder, --transformer_path from a directory save_reference_dir
   wrote, a seeded umT5-XXL behind the stub tokenizer): two outputs of
   seeds 60 and 61, the first equal bit for bit to a single --prompt run
   of seed 60.
15. The data path: (a) a 122-frame 1280 x 720 24 fps clip (a panning
   texture and a moving disc) written by OpenCV; (b)
   scripts/gen_latents_torch.py's main on it, its config written in the
   reference's pre_*.yaml schema at configs/pre_480.yaml's sizing and read
   by load_config, with phase 13's seeded VAE file and a seeded ViT-H/14
   and umT5-XXL handed in (the stub tokenizer): the manifest's keys and
   paths, latents and f1_black [1, 16, 21, 60, 104], img_clip [1, 257,
   1280], the captions [1, n, 4096], all finite, their first latent frames
   equal and the later ones apart, no kernel launched; seconds per part
   and the peak; (c) encode_clip_data card against CPU at 5 x 64 x 64 (the
   published VAE, 2 ViT-H blocks); (d) scripts/encode_captions_torch.py's
   main over a manifest without text paths, with --null_dir; a second run
   skips it; (e) one i2v PRFL outer step of phase 11's config at 81 frames
   from (b)'s cache, through the trainer's read-ahead loader: the batch's
   shapes and its latents and condition equal to the cache's, metrics
   finite, launches as derived, the wait on the batch iterator printed;
   (f) a whole-CLIP reference file at the published widths, 2 blocks in
   each tower with log_scale, post_norm and head, read by
   load_reference_clip bit for bit; XLM-R with its head (2 x 77 tokens, one
   row padded) and ViT-H card against CPU; XLM-R large at 24 layers timed
   on the card.
16. Multi-GPU on one card (every check with more than one rank runs on
   CPU gloo in tests/test_torch_parallel*.py, or on several cards in
   scripts/multi_gpu_check_torch.py): (a) the
   PAVRM Bradley-Terry step of configs/train_pavrm_i2v_480.yaml at i2v-14B
   width (8 blocks, win and lose in one graph, 257 image keys) through
   scripts/train_pavrm_torch.py, 2 steps at 21 frames with every backward
   on K5, with and without train.offload_opt_state: the moments in pinned
   host memory, loss and parameters bit for bit equal; then 2 steps at 81
   frames with the moments offloaded and remat "full" (under "attn" the two
   sides' activations overflow the card even so), s/step,
   peak under the card's memory, the moments' host-card round trip timed
   alone; (b) a process group of one rank over NCCL in this process: a
   2-block t2v-1.3B refl + SFT step at 21 frames under each FSDP2 strategy
   against the unwrapped step ("none" bit for bit, the others' refl
   forward bit for bit and the rest within the bounds of the reordered
   gradient sums), ulysses_attention at degree 1 against the plain call
   bit for bit, and configs/train_prfl_t2v_480.yaml (phase 7's changes)
   with dataset.sp_size 4 through train_prfl_torch.main for one outer
   step, sp clamped to 1, its metrics equal to the sp_size-1 run's; the
   group torn down; (c) the kernels at the shapes sequence parallelism of
   degree 4 gives t2v-14B at 720*1280, 81 frames (75,600 tokens): K1 and
   K4 at the Ulysses self-attention (10 heads x 75,600), K3 and K4 at the
   token-parallel text cross-attention (40 heads x 18,900 queries x 512
   keys), K6-K9 at [1, 18,900, 5120] with the first rank's rope rows,
   each against its plain version, timed beside its bound and library
   call.
17. The last ported modules: (a) configs/train_prfl_t2v_480.yaml (phase
   7's changes) with model.lora.use_lora (rank 128 on the self- and
   cross-attention q/k/v/o) and EMA through scripts/train_prfl_torch.py,
   one outer step at 21 frames and one at 81: metrics finite, launches as
   derived (expected_train_launches(lora=True)), the base bit for bit
   unchanged, B moved, t_refl, t_sft and the peak printed; the checkpoint
   holds the merged DiT and lora_{transformer,kohya,diffusers}.safetensors
   and no optimizer state, the EMA's beside it, and the merged weights
   equal the base plus A B of the saved factors exactly; then 2 t2v-1.3B
   blocks with rank-128 factors at one latent frame, the factors'
   gradients card against CPU; (b) ring attention on one card through
   ops/ring_attention.py's own hop loops with a local rotation of r
   virtual ranks, at the t2v-14B 720*1280 81-frame USP shard of ring 2 x
   Ulysses 4 on 8 GPUs (batch 2, 10 heads, 75,600 tokens: 37,800 a rank at
   r = 2, 18,900 at r = 4; K1 and K4 per hop), the shifted route at 18,900
   tokens (K2, K5), and K3 hops at 2 x 12 heads x 9,360 over r = 4: output
   and gradients against the whole-sequence kernels and, on two heads,
   the plain versions; one hop's forward, merge and backward timed beside
   their bounds; (c) phase 7's 21-frame step under remat "dots_all" against
   "attn": the same reward, the grad norm within 1%, the time and peak of
   each; (d) inference_torch.main --ring_size 2 on one card: clamped to
   ring 1, the latents of --ring_size 1 bit for bit; (e) the metric
   logger: TensorBoard's event file where it imports, else log.txt alone.

The line before the last is a JSON object of per-kernel results (launches
counted on the main paths: serving and training for the forward and
backward kernels, the split-route gradient call and the split-backward
training step for K5, the probe scripts for P1/P2, the un-normed pipeline
for R, phase 11's serving and training, phase 12's runs, phase 13's
and 14's CLIs, phase 15's training step, phase 16's steps and phase 17's
LoRA steps, rings, remat steps and CLI runs); the last is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when no
CUDA device is available or the package is missing.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = ""  # nvidia-smi's name and power limit, set by main()
T_START = 0.0  # when main() began
SIZE = "832*480"
GRID_81 = (21, 30, 52)   # latent grid of an 81-frame 832*480 request
GRID_9 = (3, 30, 52)
TEXT_LEN = 512
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "K8": ("hyvideo_prfl_torch/csrc/ln_scale_shift.cu",
           "hyvideo_prfl_tpu/ops/stream.py:75"),
    "K6": ("hyvideo_prfl_torch/csrc/qknorm_rope.cu",
           "hyvideo_prfl_tpu/ops/qknorm_rope.py:85"),
    "K1": ("hyvideo_prfl_torch/csrc/flash_fwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:250"),
    "K3": ("hyvideo_prfl_torch/csrc/flash_fwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:331"),
    "K2": ("hyvideo_prfl_torch/csrc/flash_fwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:198"),
    "K3s": ("hyvideo_prfl_torch/csrc/flash_fwd.cu",
            "hyvideo_prfl_tpu/ops/flash_attention.py:351"),
    "K4": ("hyvideo_prfl_torch/csrc/flash_bwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:453"),
    "K5": ("hyvideo_prfl_torch/csrc/flash_bwd.cu",
           "hyvideo_prfl_tpu/ops/flash_attention.py:371"),
    "K7": ("hyvideo_prfl_torch/csrc/qknorm_rope_bwd.cu",
           "hyvideo_prfl_tpu/ops/qknorm_rope.py:106"),
    "K9": ("hyvideo_prfl_torch/csrc/ln_scale_shift_bwd.cu",
           "hyvideo_prfl_tpu/ops/stream.py:84"),
    "K10": ("hyvideo_prfl_torch/csrc/flash_fwd_qk8.cu",
            "hyvideo_prfl_tpu/ops/flash_attention.py:290"),
    "P1": ("hyvideo_prfl_torch/csrc/int8_probe.cu", "scripts/probe_int8_rate.py:25"),
    "P2": ("hyvideo_prfl_torch/csrc/int8_probe.cu", "scripts/probe_int8_mosaic.py:29"),
    "R": ("hyvideo_prfl_torch/csrc/rope.cu", "hyvideo_prfl_tpu/ops/rope_pallas.py:32"),
}
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 bytes/s, ops/s by type
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def _add(total, counts, times=1):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n * times
    return total


def dit_launches(n_layers, backward, ctx_grad=1, head=True, remat_policy="attn", qk8=False,
                 shifted=False, qk_norm=True, cross_attn_norm=True, self_single=False,
                 merged_bwd=True, i2v=False):
    """Kernel launches of one DiT forward, and of its backward.

    A forward launches, per block, three K8 (two adaLN norms and norm3; two
    without cross_attn_norm), four K6 (self q and k with rope, cross q and
    k without; none without qk_norm, where two R rotate the self q and k
    instead), one self-attention forward and one text cross-attention
    forward, plus one K8 at the head. An i2v/flf2v model (``i2v``) adds, per
    block, the image cross-attention forward (257 or 514 keys: the
    cross-attention's form) and, under qk_norm, the K6 of its k_img. The
    attention forwards are K1 and K3,
    or K10 and K3 under quant_attn "int8" (qk8, at the slice's streaming
    lengths), or K2 and K3s on the shifted route (HYV_FLASH_BOUNDED=0,
    shifted, or no qk_norm). With ``self_single`` (a token count whose keys
    fit one block, uses_single_block) the self-attention takes the
    single-block form too: K3, or K3s on the shifted route; the int8
    forward only takes streaming keys. The int8 forward has no backward. The backward
    launches, per block, one K9 per K8, one K4 per attention call (every
    call at the slice's lengths takes the merged route; K5 in its place
    under HYV_FLASH_MERGED_BWD=0, ``merged_bwd`` False) and one K7 per
    qk-norm whose input needs a gradient: four (five for i2v), or three
    when the text and image context need none (the frozen LRM's cross k and
    k_img), or two R (the rotations' backward) without qk_norm; plus one K9
    at the head. Remat re-runs
    forward work inside the backward: under "attn" each block's
    checkpointed segments re-run up to their last op that saved a tensor,
    which is every K8, every K6 whose output is differentiated and every
    R, never the attention forward; under "full" the whole block forward
    re-runs."""
    k8 = 2 + int(cross_attn_norm)
    ctx_norms = (1 + int(i2v)) * ctx_grad  # cross k (and k_img) K6/K7 with a context gradient
    cross = 1 + int(i2v)
    norms = {"K6": 4 + int(i2v)} if qk_norm else {"R": 2}
    if qk8 and qk_norm and not shifted:
        attn = {"K10": 1, "K3": cross}
    elif shifted or not qk_norm:
        attn = {"K2": 1, "K3s": cross}
    else:
        attn = {"K1": 1, "K3": cross}
    if self_single:
        attn = {"K3s": 1 + cross} if shifted or not qk_norm else {"K3": 1 + cross}
    fwd_block = {"K8": k8, **norms, **attn}
    total = _add({"K8": 1} if head else {}, fwd_block, n_layers)
    if backward:
        norm_recompute = {"K6": 3 + ctx_norms} if qk_norm else {"R": 2}
        recompute = {"attn": {"K8": k8, **norm_recompute}, "full": fwd_block,
                     "off": {}}[remat_policy]
        norm_bwd = {"K7": 3 + ctx_norms} if qk_norm else {"R": 2}
        attn_bwd = {"K4" if merged_bwd else "K5": 1 + cross}
        total = _add(total, _add({"K9": k8, **norm_bwd, **attn_bwd}, recompute), n_layers)
        if head:
            total = _add(total, {"K9": 1})
    return total


def expected_train_launches(n_policy, n_lrm, mid, remat_policy="attn", rollout_quant=None,
                            shifted=False, merged_bwd=True, i2v=False, lora=False):
    """Kernel launches of one outer PRFL step: the refl step (mid no-grad
    rollout forwards, through the int8 model under rollout_quant "int8",
    one policy forward and backward, one forward and backward of the
    head-less LRM, whose text and image context need no gradient) and the
    SFT step (one policy forward and backward, whose image context does,
    through img_emb); ``shifted`` for HYV_FLASH_BOUNDED=0, ``merged_bwd``
    False for HYV_FLASH_MERGED_BWD=0, ``i2v`` for an i2v/flf2v model. Under
    ``lora`` (model.lora.use_lora on q/k/v/o) the base is frozen: the first
    block's first adaLN norm then reads a stream and a modulation that need
    no gradient, so each policy backward has one K9 fewer; every other norm
    and attention still has a differentiated input (the factors)."""
    policy = dit_launches(n_policy, True, remat_policy=remat_policy, shifted=shifted,
                          merged_bwd=merged_bwd, i2v=i2v)
    if lora:
        policy = _add(policy, {"K9": -1})
    lrm = dit_launches(n_lrm, True, ctx_grad=0, head=False, remat_policy=remat_policy,
                       shifted=shifted, merged_bwd=merged_bwd, i2v=i2v)
    rollout = dit_launches(n_policy, False, qk8=rollout_quant == "int8", shifted=shifted,
                           i2v=i2v)
    return _add(_add(_add({}, rollout, mid), lrm), policy, 2)


def expected_pavrm_launches(n_blocks, loss="ce", remat_policy="attn", i2v=False, **kw):
    """Kernel launches of one PAVRM step: a forward and backward of the
    head-less tower per scored side (one for "ce", two for "bt": win and
    lose). The text and image context need no gradient (the embeddings are
    frozen), but the blocks' k projections and norm gains train, so every
    cross-attention k norm runs its backward, as in the policy; the pool and
    the reward MLP are plain PyTorch."""
    tower = dit_launches(n_blocks, True, head=False, remat_policy=remat_policy, i2v=i2v, **kw)
    return _add({}, tower, 2 if loss == "bt" else 1)


class SmokeFailure(RuntimeError):
    pass


def announce(text: str) -> None:
    """A phase's heading, with the seconds since the run began."""
    print(f"{text} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_err(got, ref):
    import torch

    d = (got.float() - ref.float()).abs().max().item()
    return d, ref.float().abs().max().item(), bool(torch.isfinite(got.float()).all())


def timed_turns(fns, reps=5, calls=10):
    """Median ms per call of each named function, in turns (forward order,
    then reversed, ...) after a warm-up. Each turn times `calls`
    back-to-back calls between two CUDA events, queued behind a device
    sleep, so the events time the device alone even where a call takes less
    device time than its host work (the norm kernels at width 1280: a few
    microseconds)."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns.items())
    for i in range(reps):
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            # ~10 ms, so the turn's calls are all queued before the device
            # reaches them: one call of F.layer_norm's autograd backward
            # takes ~0.2 ms of host time
            torch.cuda._sleep(20_000_000)
            ev0.record()
            for _ in range(calls):
                fn()
            ev1.record()
            torch.cuda.synchronize()
            times[name].append(ev0.elapsed_time(ev1) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def timed_pair(kernel_fn, plain_fn, reps=5, calls=10):
    """(kernel ms, plain ms), in turns plain, kernel, kernel, plain, ..."""
    t = timed_turns({"plain": plain_fn, "kernel": kernel_fn}, reps, calls)
    return t["kernel"], t["plain"]


def bound(nbytes, **ops):
    """The least time the card could take for the work: the bytes it must
    move (each input read once, each output written once) over the memory
    rate, or the operations over each type's peak, whichever is larger."""
    t_bytes = nbytes / PEAK["bytes"]
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sdpa_flash(q, k, v):
    """PyTorch's own flash attention on [B, N, L, D] q/k/v: the library call
    timed beside K1/K3 and, through its backward, K4/K5 (library_ms). The
    port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v)


def report(name, err, ref_max, finite, bound_, ms, plain_ms, results, **extra):
    print(f"  {name}: max_abs_err {err:.3e} (bound {bound_:.3e}, max|ref| {ref_max:.3e}),"
          f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          + "".join(f", {k} {v:.4f}" for k, v in extra.items() if isinstance(v, float)))
    expect(finite, f"{name}: non-finite output")
    expect(err <= bound_, f"{name}: error {err} over bound {bound_}")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **extra}


def phase_kernels(results):
    """Phase 2: each forward kernel against its plain version at the
    81-frame shapes."""
    import torch

    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import qknorm_rope as qr
    from hyvideo_prfl_torch.ops import stream

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    b, n, d = 2, 12, 128
    dim = n * d
    lq = math.prod(GRID_81)
    rows = b * lq * dim

    # K8: the block sites write bf16, the head writes fp32.
    # Bound: the two differ only in fp32 summation order, which can move a
    # value across a rounding boundary: one bf16 ulp of the largest |out|
    # (2^-7 max|ref|) for bf16, 1e-5 max|ref| for fp32.
    x = torch.randn(b, lq, dim, device=dev, generator=g)
    s = 1.0 + 0.1 * torch.randn(b, dim, device=dev, generator=g)
    t = 0.1 * torch.randn(b, dim, device=dev, generator=g)
    ref32 = stream.ln_scale_shift_plain(x, s, t, 1e-6, torch.float32)
    e32, m32, f32 = max_err(stream._kernel(x, s, t, 1e-6, torch.float32), ref32)
    print(f"  K8 fp32-out: max_abs_err {e32:.3e} (bound {1e-5 * m32:.3e})")
    expect(f32 and e32 <= 1e-5 * m32, "K8 fp32-out disagrees with its plain version")
    ref = stream.ln_scale_shift_plain(x, s, t, 1e-6, torch.bfloat16)
    err, rmax, fin = max_err(stream._kernel(x, s, t, 1e-6, torch.bfloat16), ref)
    ms, pms = timed_pair(lambda: stream._kernel(x, s, t, 1e-6, torch.bfloat16),
                         lambda: stream.ln_scale_shift_plain(x, s, t, 1e-6, torch.bfloat16))
    # no single PyTorch call: layer_norm has no per-batch modulation and
    # writes its input's type, not bf16 from fp32
    report("K8", err, rmax, fin, 2.0 ** -7 * rmax, ms, pms, results,
           **bound(rows * (4 + 2), fp32=8 * rows), library_ms=None)
    del x, ref, ref32

    # K6 with rope (self-attention q/k at 32,760 tokens) and without (cross
    # q at 32,760, cross k at the 512 text tokens).
    # Bound: r differs in its last fp32 bits, so bf16(x r) may round the
    # other way, and the rope sum mixes two such values: two bf16 ulps of
    # the largest |out| (2^-6 max|ref|).
    xq = torch.randn(b, lq, dim, device=dev, generator=g).bfloat16()
    w = 1.0 + 0.1 * torch.randn(dim, device=dev, generator=g)
    c_np, s_np = rope_tables_rolled_np(GRID_81, d)
    c_tab, s_tab = torch.from_numpy(c_np).to(dev), torch.from_numpy(s_np).to(dev)
    for name, xx, rope in (("norm-only q", xq, False),
                           ("norm-only k", xq[:, :TEXT_LEN].contiguous(), False)):
        e_, m_, f_ = max_err(qr._kernel(xx, w, None, None, n, 1e-6, rope),
                             qr.rmsnorm_rope_plain(xx, w, None, None, n, 1e-6, rope))
        print(f"  K6 {name}: max_abs_err {e_:.3e} (bound {2.0 ** -6 * m_:.3e})")
        expect(f_ and e_ <= 2.0 ** -6 * m_, f"K6 {name} disagrees with its plain version")
    ref = qr.rmsnorm_rope_plain(xq, w, c_tab, s_tab, n, 1e-6, True)
    err, rmax, fin = max_err(qr._kernel(xq, w, c_tab, s_tab, n, 1e-6, True), ref)
    ms, pms = timed_pair(lambda: qr._kernel(xq, w, c_tab, s_tab, n, 1e-6, True),
                         lambda: qr.rmsnorm_rope_plain(xq, w, c_tab, s_tab, n, 1e-6, True))
    # no single PyTorch call: rms_norm over the 1,536 features of all heads
    # fused with the rope and the head-major relayout
    report("K6", err, rmax, fin, 2.0 ** -6 * rmax, ms, pms, results,
           **bound(rows * (2 + 2) + 2 * lq * d * 4, fp32=7 * rows), library_ms=None)
    del xq, ref

    # K1 (self-attention, 32,760 keys: a 56-key ragged last tile) and K3
    # (text cross-attention, 512 keys). Unit-variance q/k stand in for the
    # qk-normed activations. The plain version runs in chunks of q rows.
    # Bound: exp2 on the card is within 2 ulp of torch.exp2, so bf16(p) can
    # round the other way for a few keys, and o is rounded to bf16: two bf16
    # ulps of the largest |o| (2^-6 max|ref|); lse 1e-5 max|lse| (fp32 sums
    # in another order).
    q = torch.randn(b, n, lq, d, device=dev, generator=g).bfloat16()
    keep = {}
    for name, lk in (("K1", lq), ("K3", TEXT_LEN)):
        k = torch.randn(b, n, lk, d, device=dev, generator=g).bfloat16()
        v = torch.randn(b, lk, n, d, device=dev, generator=g).bfloat16()
        single = name == "K3"
        expect(fa.uses_single_block(lk) == single, f"{name}: wrong route for lk={lk}")
        o, lse = fa.flash_fwd_kernel(q, k, v, single)
        po, plse = fa.flash_attention_plain(q, k, v)
        el, ml, fl = max_err(lse, plse)
        print(f"  {name} lse: max_abs_err {el:.3e} (bound {1e-5 * ml:.3e})")
        expect(fl and el <= 1e-5 * ml, f"{name} lse disagrees with its plain version")
        err, rmax, fin = max_err(o, po)
        if name == "K1":
            keep = {"k": k, "v": v, "o": o, "po": po}
        del o, lse, po, plse
        vt = v.movedim(1, 2).contiguous()  # SDPA's [B, N, L, D]
        fns = {"plain": lambda: fa.flash_attention_plain(q, k, v),
               "kernel": lambda: fa.flash_fwd_kernel(q, k, v, single),
               "library": lambda: sdpa_flash(q, k, vt)}
        if single:
            # the streaming form at the same lk: K1's instance over 4 tiles
            fns["streaming"] = lambda: fa.flash_fwd_kernel(q, k, v, False)
        # K3 runs in well under a millisecond: 20 calls a turn keep the
        # wrapper's host time out of the events
        t = timed_turns(fns, reps=5, calls=20) if single else timed_turns(fns, reps=3, calls=2)
        flop = 4 * b * n * lq * lk * d
        bnd = bound(2 * b * n * (lq + lk) * d * 2, bf16=flop)
        extra = {"streaming_ms": t["streaming"]} if single else {}
        print(f"  {name}: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s (kernel, "
              f"{bnd['bound_ms'] / t['kernel']:.3f} of its bound), "
              f"{flop / (t['plain'] * 1e9):.1f} (plain), "
              f"{flop / (t['library'] * 1e9):.1f} (SDPA flash)"
              + (f", {flop / (t['streaming'] * 1e9):.1f} (streaming form)" if single else ""))
        report(name, err, rmax, fin, 2.0 ** -6 * rmax, t["kernel"], t["plain"], results,
               **bnd, library_ms=t["library"], **extra)
        del vt
        if name == "K3":
            del k, v

    # K10 at the self-attention shape, on K1's inputs: q and k quantized per
    # (batch, head) as the port quantizes them before the launch.
    # Bound against its plain version (same q8, k8, c): the int32 scores are
    # exact on both; exp2 within 2 ulp flips bf16(p) on a few keys and o
    # rounds to bf16: two bf16 ulps of max|o|, lse 1e-5 max|lse|, as K1.
    k, v = keep["k"], keep["v"]
    q8, sq = fa.quantize_bn(q)
    k8, sk = fa.quantize_bn(k)
    c = fa.qk8_scale(sq, sk, d)
    o10, lse10 = fa.flash_qk8_kernel(q8, k8, v, c)
    po10, plse10 = fa.flash_attention_qk8_plain(q8, k8, v, c)
    el, ml, fl = max_err(lse10, plse10)
    print(f"  K10 lse: max_abs_err {el:.3e} (bound {1e-5 * ml:.3e})")
    expect(fl and el <= 1e-5 * ml, "K10 lse disagrees with its plain version")
    err, rmax, fin = max_err(o10, po10)
    # Against K1 on the same bf16 q/k/v: the plain versions differ only by
    # the quantization of q and k (their max distance is that effect), and
    # each kernel lies within two bf16 ulps of max|o| of its plain version,
    # so |K10 - K1| <= max|plain10 - plain1| + 4 ulps. First-order, the
    # per-head rounding (a uniform error of s/2 on 256 terms, s = max|x|/127)
    # moves each logit by ~0.017 here, and o, an average over ~32k keys,
    # by ~1e-4; the check prints what the card shows.
    quant, _, _ = max_err(po10, keep["po"])
    e1, m1, _ = max_err(o10, keep["o"])
    b1 = quant + 4 * 2.0 ** -7 * m1
    print(f"  K10 against K1: max_abs_err {e1:.3e} (bound {b1:.3e}: quantization effect "
          f"{quant:.3e} between the plain versions, max|o| {m1:.3e})")
    expect(e1 <= b1, f"K10 against K1: {e1} over {b1}")
    del o10, lse10, po10, plse10, keep
    t = timed_turns({"plain": lambda: fa.flash_attention_qk8_plain(q8, k8, v, c),
                     "kernel": lambda: fa.flash_qk8_kernel(q8, k8, v, c),
                     "K1": lambda: fa.flash_fwd_kernel(q, k, v, False)}, reps=3, calls=2)
    tq = timed_turns({"quantize": lambda: (fa.quantize_bn(q), fa.quantize_bn(k))},
                     reps=3, calls=2)["quantize"]
    ops = 2 * b * n * lq * lq * d  # of each product
    print(f"  K10: {2 * ops / (t['kernel'] * 1e9):.1f} TOPS (int8 score + bf16 p v), K1 "
          f"{2 * ops / (t['K1'] * 1e9):.1f} TFLOP/s in the same turns; per-head "
          f"quantization of q and k outside the kernel {tq:.4f} ms")
    # no single PyTorch call computes the int8 score softmax: library_ms null
    report("K10", err, rmax, fin, 2.0 ** -6 * rmax, t["kernel"], t["plain"], results,
           **bound(2 * b * n * lq * d + 2 * b * n * lq * d * 2 + b * n * 4, int8=ops, bf16=ops),
           library_ms=None, k1_ms=t["K1"])
    del q, k, v, q8, k8
    torch.cuda.empty_cache()


def phase_shifted_kernels(results):
    """Phase 2b: the shifted forward (K2, K3s) and the rope R against their
    plain versions at the 81-frame CFG-2 shapes."""
    import torch

    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import rope

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    b, n, d = 2, 12, 128
    lq = math.prod(GRID_81)
    ulp2 = 2.0 ** -6  # two bf16 ulps of the largest |o|

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=g)).bfloat16()

    def check_fwd(label, o, lse, ref, bound_rel=ulp2):
        # Bound: as K1's, two bf16 ulps of max|o|: K2 rounds bf16(p) at the
        # running max rather than the row max, so any p may round the other
        # way (the errors average over the keys), and o rounds to bf16; lse
        # 1e-5 max|lse| (fp32 sums in another order)
        el, ml, fl = max_err(lse, ref[1])
        err, rmax, fin = max_err(o, ref[0])
        print(f"  {label}: max_abs_err {err:.3e} (bound {bound_rel * rmax:.3e}, max|ref| "
              f"{rmax:.3e}); lse {el:.3e} (bound {1e-5 * ml:.3e})")
        expect(fl and el <= 1e-5 * ml, f"{label}: lse disagrees with its plain version")
        expect(fin, f"{label}: non-finite output")
        expect(err <= bound_rel * rmax, f"{label}: error {err} over {bound_rel * rmax}")
        return err, rmax

    # K2 at the self-attention shape (32,760 keys: a 56-key ragged last
    # tile), on unit-variance q/k standing in for qk-normed activations
    q, k = randn(b, n, lq, d), randn(b, n, lq, d)
    v = randn(b, lq, n, d)
    o2, lse2 = fa.flash_fwd_kernel(q, k, v, False, True)
    ref2 = fa.flash_attention_shifted_plain(q, k, v)
    err2, rmax2 = check_fwd("K2 against its plain version", o2, lse2, ref2)
    # against K1 on the same inputs: the two plain versions differ only in
    # where bf16 rounds p, and each kernel lies within two ulps of its own,
    # so |K2 - K1| <= max|plain2 - plain1| + 4 ulps of max|o|
    o1, _ = fa.flash_fwd_kernel(q, k, v, False, False)
    po1, _ = fa.flash_attention_plain(q, k, v)
    forms, _, _ = max_err(ref2[0], po1)
    e21, m21, _ = max_err(o2, o1)
    b21 = forms + 2 * ulp2 * m21
    print(f"  K2 against K1: max_abs_err {e21:.3e} (bound {b21:.3e}: the plain forms differ "
          f"by {forms:.3e}, max|o| {m21:.3e})")
    expect(e21 <= b21, f"K2 against K1: {e21} over {b21}")
    del o1, po1, o2, lse2, ref2
    # the user mask: batch 0 keeps all 32,760 keys, batch 1 the first 20,001
    kvalid = torch.tensor([lq, 20001], device=dev, dtype=torch.int32).repeat_interleave(n)
    om, lsem = fa.flash_fwd_kernel(q, k, v, False, True, kvalid)
    check_fwd("K2 with k_valid_len [32760, 20001]", om, lsem,
              fa.flash_attention_shifted_plain(q, k, v, kvalid))
    del om, lsem
    vt = v.movedim(1, 2).contiguous()  # SDPA's [B, N, L, D]
    t = timed_turns({"plain": lambda: fa.flash_attention_shifted_plain(q, k, v),
                     "kernel": lambda: fa.flash_fwd_kernel(q, k, v, False, True),
                     "K1": lambda: fa.flash_fwd_kernel(q, k, v, False, False),
                     "library": lambda: sdpa_flash(q, k, vt)}, reps=3, calls=2)
    flop = 4 * b * n * lq * lq * d
    bnd = bound(2 * b * n * 2 * lq * d * 2, bf16=flop)
    print(f"  K2: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s (kernel, "
          f"{bnd['bound_ms'] / t['kernel']:.3f} of its bound), K1 "
          f"{flop / (t['K1'] * 1e9):.1f} in the same turns ({t['kernel'] / t['K1']:.3f}x its "
          f"time), {flop / (t['plain'] * 1e9):.1f} (plain), "
          f"{flop / (t['library'] * 1e9):.1f} (SDPA flash)")
    report("K2", err2, rmax2, True, ulp2 * rmax2, t["kernel"], t["plain"], results,
           **bnd, library_ms=t["library"], k1_ms=t["K1"])
    del q, k, v, vt

    # logits near 300: q and k of standard deviation 6.7 give logits of
    # standard deviation ~45, the largest of the 2.6e10 near 300. exp of
    # anything past ~88 overflows fp32: K1 returns inf / inf there.
    q, k = randn(b, n, lq, d, scale=6.7), randn(b, n, lq, d, scale=6.7)
    v = randn(b, lq, n, d)
    s0 = (q[:, :, :512].float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    top = s0.abs().max().item()
    del s0
    o1, _ = fa.flash_fwd_kernel(q, k, v, False, False)
    k1_finite = bool(torch.isfinite(o1.float()).all())
    del o1
    oh, lseh = fa.flash_fwd_kernel(q, k, v, False, True)
    print(f"  large logits (largest |logit| of the first 512 q rows {top:.1f}; max lse "
          f"{lseh.max().item():.1f}): K1 output finite: {k1_finite}")
    expect(top > 150, f"the large-logit inputs reach only {top}")
    expect(not k1_finite, "K1 stayed finite: the inputs do not leave the bounded range")
    check_fwd("K2 at large logits", oh, lseh, fa.flash_attention_shifted_plain(q, k, v))
    del q, k, v, oh, lseh

    # K3s at the text cross-attention shape (lq 32,760 x lk 512)
    q = randn(b, n, lq, d)
    k, v = randn(b, n, TEXT_LEN, d), randn(b, TEXT_LEN, n, d)
    o3, lse3 = fa.flash_fwd_kernel(q, k, v, True, True)
    err3, rmax3 = check_fwd("K3s against its plain version", o3, lse3,
                            fa.flash_attention_shifted_plain(q, k, v))
    vt = v.movedim(1, 2).contiguous()
    # 20 calls a turn, as K3's, in turns with the shifted streaming form
    # (K2's instance) at the same lk
    t = timed_turns({"plain": lambda: fa.flash_attention_shifted_plain(q, k, v),
                     "kernel": lambda: fa.flash_fwd_kernel(q, k, v, True, True),
                     "K3": lambda: fa.flash_fwd_kernel(q, k, v, True, False),
                     "streaming": lambda: fa.flash_fwd_kernel(q, k, v, False, True),
                     "library": lambda: sdpa_flash(q, k, vt)}, reps=5, calls=20)
    flop = 4 * b * n * lq * TEXT_LEN * d
    bnd = bound(2 * b * n * (lq + TEXT_LEN) * d * 2, bf16=flop)
    print(f"  K3s: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s (kernel, "
          f"{bnd['bound_ms'] / t['kernel']:.3f} of its bound), K3 "
          f"{flop / (t['K3'] * 1e9):.1f} in the same turns, {flop / (t['plain'] * 1e9):.1f} "
          f"(plain), {flop / (t['library'] * 1e9):.1f} (SDPA flash), "
          f"{flop / (t['streaming'] * 1e9):.1f} (streaming form)")
    report("K3s", err3, rmax3, True, ulp2 * rmax3, t["kernel"], t["plain"], results,
           **bnd, library_ms=t["library"], k3_ms=t["K3"], streaming_ms=t["streaming"])
    del q, k, v, vt, o3, lse3

    # R forward and backward at the self-attention q/k, [2, 32,760, 12, 128]
    # bf16. Bound: 0. The kernel and the plain version form the same fp32
    # products and sum, each rounded once, then one rounding to bf16.
    c_np, s_np = rope_tables_rolled_np(GRID_81, d)
    c_tab, s_tab = torch.from_numpy(c_np).to(dev), torch.from_numpy(s_np).to(dev)
    s_bwd = torch.roll(s_tab, d // 2, dims=-1).contiguous()
    x, gy = randn(b, lq, n, d), randn(b, lq, n, d)
    worst, rmax_r = 0.0, 0.0
    for label, inp, tab in (("forward", x, s_tab), ("backward (S rolled)", gy, s_bwd)):
        err, rmax, fin = max_err(rope.rope_kernel(inp, c_tab, tab),
                                 rope.rope_rotate_plain(inp, c_tab, tab))
        print(f"  R {label}: max_abs_err {err:.3e} (bound 0: bit for bit; max|ref| {rmax:.3e})")
        expect(fin and err == 0.0, f"R {label} differs from its plain version by {err}")
        worst, rmax_r = max(worst, err), max(rmax_r, rmax)
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(rope.rope_rotate(xg, c_tab, s_tab), xg, gy)
    expect(torch.equal(dx, rope.rope_rotate_plain(gy, c_tab, s_bwd)),
           "R's autograd backward differs from the rotation by the rolled table")
    del xg, dx
    ms, pms = timed_pair(lambda: rope.rope_kernel(x, c_tab, s_tab),
                         lambda: rope.rope_rotate_plain(x, c_tab, s_tab), reps=5, calls=10)
    # x read and out written (bf16), the two [L, 128] fp32 tables read once;
    # three fp32 operations per element. No single PyTorch call rotates.
    report("R", worst, rmax_r, True, 0.0, ms, pms, results,
           **bound(2 * x.numel() * 2 + 2 * lq * d * 4, fp32=3 * x.numel()), library_ms=None)
    del x, gy
    torch.cuda.empty_cache()


def phase_model():
    """Phase 3: a 1-block full-width WanModel, card against CPU, in bf16 and
    as the int8 model."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.utils.checkpoint import (
        from_jax_params, quantize_state, seeded_jax_tree)

    # 1 block (cut from 2 for phase 17's room)
    cfg = wan_dit.t2v_1_3b(num_layers=1)
    state = from_jax_params(seeded_jax_tree(cfg, seed=7), cfg)
    rng = np.random.default_rng(8)
    f, hh, ww = GRID_9[0], GRID_9[1] * 2, GRID_9[2] * 2
    x = torch.from_numpy(rng.standard_normal((2, f, hh, ww, 16), dtype=np.float32))
    t = torch.tensor([900.0, 300.0])
    ctx = torch.from_numpy(rng.standard_normal((2, TEXT_LEN, cfg.text_dim), dtype=np.float32))
    qcfg = dataclasses.replace(cfg, quant_dense="int8", quant_attn="int8")
    for label, mcfg, mstate, attn in (("bf16", cfg, state, "K1"),
                                      ("int8", qcfg, quantize_state(state, qcfg), "K10")):
        outs = {}
        for dev in ("cuda", "cpu"):
            model = wan_dit.WanModel(mcfg, device=torch.device(dev))
            model.load_state_dict(mstate)
            _build.reset_launches()
            t0 = time.perf_counter()
            with torch.inference_mode():
                outs[dev] = model(x.to(dev), t.to(dev), ctx.to(dev)).cpu()
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)
            print(f"  {label} forward on {dev}: {time.perf_counter() - t0:.2f} s")
            del model
        err, rmax, fin = max_err(outs["cuda"], outs["cpu"])
        # Bound: bf16 matmuls accumulate in another order on the card than on
        # the CPU and activations round to bf16 at a dozen points per block,
        # so after a block a few bf16 ulps of the largest value remain:
        # 3e-2 max|cpu|, the CPU tests' bf16 tolerance against JAX. The int8
        # model quantizes those activations, so a value that rounds apart
        # may land on the neighbouring int8 step: one step is 1/127 of a
        # token's largest value, inside the same bound.
        bound_ = 3e-2 * rmax
        print(f"  {label} whole model [2, 3, 60, 104, 16] (4,680 tokens, {attn} with an "
              f"8-key ragged tile): max_abs_err {err:.3e} (bound {bound_:.3e}, "
              f"max|cpu| {rmax:.3e}); launches {launches}")
        expect(tuple(outs["cuda"].shape) == (2, f, hh, ww, 16), f"{label} model: wrong shape")
        expect(fin and bool(torch.isfinite(outs["cpu"]).all()),
               f"{label} model: non-finite output")
        expect(rmax > 0, f"{label} model: output is all zeros")
        expect(err <= bound_, f"{label} model: error {err} over bound {bound_}")
        want = dit_launches(cfg.num_layers, False, qk8=label == "int8")
        expect(launches == want, f"{label} model: launches {launches}, expected {want}")
    torch.cuda.empty_cache()


def _serve(cli, pipe, requests, per_forward, label):
    """Answer each request through the CLI path with the launch counters set
    to 0 just before and read just after -> (latents, launches)."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    totals, latents, run_peak = {}, [], 0
    for req in requests:
        before = dict(_build.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lat = cli.run_request(pipe, req, SIZE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        want = (1, *cli.latent_grid(SIZE, req.frame_num), 16)
        print(f"  {label} request seed {req.seed}, {req.frame_num} frames, {req.sample_steps} "
              f"steps: {dt:.3f} s, {dt / req.sample_steps:.3f} s/step, latents {tuple(lat.shape)}"
              f", peak device memory {peak / 2**30:.2f} GiB")
        run_peak = max(run_peak, peak)
        expect(tuple(lat.shape) == want, f"latents {tuple(lat.shape)}, expected {want}")
        expect(bool(torch.isfinite(lat).all()), f"{label}: non-finite latents")
        for name, per in per_forward.items():
            got = _build.LAUNCHES[name] - before.get(name, 0)
            expect(got == per * req.sample_steps,
                   f"{label}: {name} launched {got} times, expected {per * req.sample_steps}")
        _add(totals, per_forward, req.sample_steps)
        latents.append(lat)
    launches = dict(_build.LAUNCHES)
    expect(launches == totals, f"{label}: launch counts {launches}, expected {totals}")
    print(f"  {label} launches {launches} (per DiT forward {per_forward}); peak device memory "
          f"{run_peak / 2**30:.2f} GiB")
    return latents, launches


def phase_serve():
    """Phase 4: three bf16 requests, the 81-frame one again on the shifted
    route, and two int8 requests through the CLI path; returns the launch
    counts of all."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa

    cli = load_script("inference_torch")
    dev = torch.device("cuda")

    def build(flags):
        args = cli.args_init(["--task", "t2v-1.3B", "--size", SIZE, "--frame_num", "21",
                              "--sample_steps", "4", "--sample_guide_scale", "5.0",
                              "--device", "cuda", *flags])
        t0 = time.perf_counter()
        pipe = cli.build_pipeline(args)
        # the JAX initialisers zero the head, which would make every latent
        # independent of the blocks: give it seeded weights (the head is not
        # quantized, so both pipelines get the same one)
        with torch.no_grad():
            pipe.model.head.head.weight.normal_(
                0.0, pipe.cfg.dim ** -0.5, generator=torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
        n_weights = sum(p.numel() for p in pipe.model.state_dict().values())
        print(f"  pipeline {flags or '(bf16)'} built once in {time.perf_counter() - t0:.2f} s "
              f"({n_weights / 1e9:.3f} B weights)")
        return pipe, args

    pipe, args = build([])
    cfg = pipe.cfg

    def embeds(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev)

    null = cli.load_or_zeros(None, (1, cfg.text_len, cfg.text_dim), dev)
    requests = [
        cli.Request(seed=42, context=embeds(101), context_null=null, frame_num=21,
                    sample_steps=4, guide_scale=args.sample_guide_scale),
        cli.Request(seed=43, context=embeds(102), context_null=null, frame_num=21,
                    sample_steps=4, guide_scale=args.sample_guide_scale),
        cli.Request(seed=44, context=embeds(103), context_null=null, frame_num=81,
                    sample_steps=2, guide_scale=args.sample_guide_scale),
    ]
    bf16, launches = _serve(cli, pipe, requests, dit_launches(cfg.num_layers, False), "bf16")
    expect(not torch.equal(bf16[0], bf16[1]), "two distinct requests gave one result")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # The shifted route (HYV_FLASH_BOUNDED=0; the module switch is read at
    # call time): the 81-frame request again, through K2 and K3s only.
    # Bound: the two routes differ only in where bf16 rounds p, far less
    # than int8 against bf16 moves the latents (~0.01 relative L2, checked
    # below): 0.05, a tenth of the distance between two unrelated samples.
    fa.FLASH_BOUNDED = False
    try:
        shifted, launches_s = _serve(cli, pipe, [requests[2]],
                                     dit_launches(cfg.num_layers, False, shifted=True), "shifted")
    finally:
        fa.FLASH_BOUNDED = True
    expect(launches_s.get("K1", 0) == 0 and launches_s.get("K3", 0) == 0,
           f"the shifted route launched K1 or K3: {launches_s}")
    d = rel(shifted[0], bf16[2])
    print(f"  shifted against bounded route, seed {requests[2].seed}, 81 frames: relative L2 "
          f"distance {d:.4f} (bound 0.05); K1 and K3 launched 0 times")
    expect(d <= 0.05, f"the shifted route's latents lie {d} from the bounded route's")
    del pipe
    torch.cuda.empty_cache()

    pipe, _ = build(["--quant", "int8", "--quant_attn", "int8"])
    int8, launches8 = _serve(cli, pipe, [requests[0], requests[2]],
                             dit_launches(cfg.num_layers, False, qk8=True), "int8")
    del pipe
    torch.cuda.empty_cache()

    # Bound: the int8 sample of a seed must stay near the bf16 sample of the
    # same seed. Two unrelated samples lie ~sqrt(2) of a norm apart (seeds 42
    # and 43 below); W8A8 noise of ~1% per matmul, over 30 blocks and a
    # guidance of 5 on the cond - uncond difference, may move the latents
    # by a few tenths of that: bound 0.3 relative, a fifth of the distance
    # between two unrelated samples.
    apart = rel(bf16[1], bf16[0])
    for lat8, lat, req in ((int8[0], bf16[0], requests[0]), (int8[1], bf16[2], requests[2])):
        d = rel(lat8, lat)
        print(f"  int8 against bf16, seed {req.seed}, {req.frame_num} frames: relative L2 "
              f"distance {d:.4f} (bound 0.3; seeds 42 and 43 in bf16 lie {apart:.4f} apart)")
        expect(d <= 0.3, f"int8 latents of seed {req.seed} lie {d} from the bf16 ones")
    return _add(_add(dict(launches), launches8), launches_s)


def report_many(name, label, checks, results=None, timing=None, **extra):
    """Check each (output name, got, ref, bound relative to max|ref|); with
    a timing (kernel ms, plain ms), record it and `extra` in results."""
    worst = 0.0
    for out_name, got, ref, bound_rel in checks:
        err, rmax, fin = max_err(got, ref)
        bound = bound_rel * rmax
        print(f"  {name} {label} {out_name}: max_abs_err {err:.3e} (bound {bound:.3e}, "
              f"max|ref| {rmax:.3e})")
        expect(fin, f"{name} {label} {out_name}: non-finite output")
        expect(err <= bound, f"{name} {label} {out_name}: error {err} over bound {bound}")
        worst = max(worst, err)
    if timing is not None:
        ms, pms = timing
        print(f"  {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms"
              + "".join(f", {k} {v:.4f}" for k, v in extra.items() if isinstance(v, float)))
        results[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": pms, **extra}


def phase_bwd_kernels(results):
    """Phase 5: each backward kernel against its plain version at the
    training shapes of the 81-frame slice (batch 1: training has no CFG);
    returns the launches of the split-route gradient call (K5's path)."""
    import torch

    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import qknorm_rope as qr
    from hyvideo_prfl_torch.ops import stream

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    n, d = 12, 128
    dim = n * d
    lq = math.prod(GRID_81)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    # Flash backward. Unit-variance q/k stand in for the qk-normed
    # activations, o and lse come from K1/K3, dO is a seeded cotangent.
    # Bound: bf16(p) and bf16(ds) may round the other way where exp2 or an
    # fp32 sum differs in its last bits, and every output rounds to bf16
    # (K4's dq also adds its atomics in a run-dependent order): two bf16
    # ulps of the largest gradient (2^-6 max|ref|) per output.
    # The split route runs through the op as training would reach it: a
    # gradient of flash_attention at lq 1,024, where the JAX rule picks K5.
    # Its numbers land beside the self-attention call's as short_q_*, the
    # cross-attention's beside K4's as cross_*.
    cases = (("K4", lq, lq, "self-attention, 32,760 keys (56 valid in the last 64-key tile)"),
             ("K4", lq, TEXT_LEN, "cross-attention, 512 keys"),
             ("K5", lq, lq, "self-attention shape, called directly"),
             ("K5", 1024, lq, "lq 1,024 (the split route, through the autograd op)"))
    route_launches = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, lq_, lk_, label in cases:
        merged = name == "K4"
        if "directly" not in label:
            expect(fa.uses_merged_bwd(lq_, lk_) == merged, f"{name}: wrong route for {label}")
        q, k = randn(1, n, lq_, d), randn(1, n, lk_, d)
        v = randn(1, lk_, n, d)
        if "autograd" in label:
            qkv = [x.requires_grad_() for x in (q, k, v)]
            o, lse = fa.flash_attention(*qkv, return_lse=True, qk_layout="bnld",
                                        bounded_logits=True)
            do = randn(*o.shape)
            torch.cuda.synchronize()
            _build.reset_launches()
            got = torch.autograd.grad(o, qkv, do)
            torch.cuda.synchronize()
            route_launches = dict(_build.LAUNCHES)
            expect(route_launches == {"K5": 1}, f"the split route launched {route_launches}")
            q, k, v, o = q.detach(), k.detach(), v.detach(), o.detach()
        else:
            o, lse = fa.flash_fwd_kernel(q, k, v, fa.uses_single_block(lk_))
            do = randn(*o.shape)
            got = fa.bwd_kernel(q, k, v, o, lse, do, merged)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        cross, short_q = lk_ != lq, lq_ != lq
        del got, ref
        # the library yardstick: SDPA's flash backward on the same tensors
        # in its [B, N, L, D] layout, one op per call; K5 at the
        # self-attention in turns with K4 too, and at lq 1,024 also with its
        # dq pass unsplit (dq_splits 1), the measurement behind the split
        qs, ks = q.clone().requires_grad_(), k.clone().requires_grad_()
        vs = v.movedim(1, 2).contiguous().requires_grad_()
        out = sdpa_flash(qs, ks, vs)
        dot = do.movedim(1, 2).contiguous()
        fns = {"plain": lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do),
               "kernel": lambda: fa.bwd_kernel(q, k, v, o, lse, do, merged),
               "library": lambda: torch.autograd.grad(out, (qs, ks, vs), dot,
                                                      retain_graph=True)}
        if name == "K5" and not short_q:
            fns["k4"] = lambda: fa.bwd_kernel(q, k, v, o, lse, do, True)
        if short_q:
            fns["unsplit"] = lambda: fa.bwd_kernel(q, k, v, o, lse, do, False, dq_splits=1)
        # the cross and the lq 1,024 calls are short: 20 calls a turn
        t = timed_turns(fns, reps=5 if cross or short_q else 3,
                        calls=20 if cross or short_q else 1)
        del qs, ks, vs, out, dot
        timing = (t["kernel"], t["plain"])
        got = fa.bwd_kernel(q, k, v, o, lse, do, merged)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        flop = 10 * n * lq_ * lk_ * d  # five products of 2 flop per multiply-add
        print(f"  {name} {label}: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s (kernel), "
              f"{flop / (t['plain'] * 1e9):.1f} (plain), {flop / (t['library'] * 1e9):.1f} "
              f"(SDPA flash backward)"
              + (f", {flop / (t['k4'] * 1e9):.1f} (K4, {t['k4']:.4f} ms)" if "k4" in t else "")
              + (f", {flop / (t['unsplit'] * 1e9):.1f} (dq pass unsplit, "
                 f"{t['unsplit']:.4f} ms)" if "unsplit" in t else "")
              + f", counting the five products of the algorithm"
              f"{' (K5 runs seven)' if name == 'K5' else ''}")
        # q, k, v, dO in; dq, dk, dv out (bf16); lse and delta fp32
        extra = {**bound(n * d * 2 * (3 * lq_ + 4 * lk_) + 8 * n * lq_, bf16=flop),
                 "library_ms": t["library"]}
        for key in ("k4", "unsplit"):
            if key in t:
                extra[f"{key}_ms"] = t[key]
        splits = (fa.q_splits(n * -(-lk_ // 128), -(-lq_ // 64), sms),
                  fa.q_splits(n * -(-lq_ // 128), -(-lk_ // 64), sms))
        print(f"  {name} {label}: {extra['bound_ms'] / t['kernel']:.3f} of the bound; dk/dv "
              f"q sweep split over {splits[0]} block(s) per key tile"
              + (f", dq key range over {splits[1]} block(s) per q tile" if name == "K5" else ""))
        checks = [(o_, a, b, 2.0 ** -6) for o_, a, b in zip(("dq", "dk", "dv"), got, ref)]
        if cross or short_q:
            # recorded beside the self-attention call's numbers
            part = {}
            report_many(name, label, checks, part, timing, **extra)
            prefix = "cross" if cross else "short_q"
            results[name].update({f"{prefix}_{key}": val for key, val in part[name].items()})
        else:
            report_many(name, label, checks, results, timing, **extra)
        if name == "K5" and not short_q:
            # dq written once per q tile: the same bits on a second call
            again = fa.bwd_kernel(q, k, v, o, lse, do, False)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  K5 {label}: dq, dk, dv bitwise equal on a second call: {same}")
            expect(same, "K5 is not deterministic")
            del again
        del q, k, v, o, lse, do, got, ref
        torch.cuda.empty_cache()
    _k4_k5_turns(results)

    # K7 at the self-attention q/k (rope), cross q (norm only, 32,760 rows)
    # and cross k (norm only, the 512 text rows). Bound: dx rounds to bf16
    # and r differs in its last fp32 bits, so two bf16 ulps of max|dx|; dw
    # sums 32,760 rows in another order and bf16(x r) may round the other
    # way on a few: one bf16 ulp of max|dw| (2^-7).
    w = 1.0 + 0.1 * torch.randn(dim, device=dev, generator=g)
    c_np, s_np = rope_tables_rolled_np(GRID_81, d)
    c_tab, s_tab = torch.from_numpy(c_np).to(dev), torch.from_numpy(s_np).to(dev)
    for label, l, rope in (("rope, 32,760 rows", lq, True), ("norm-only, 32,760 rows", lq, False),
                           ("norm-only, 512 rows", TEXT_LEN, False)):
        x = randn(1, l, dim)
        gg = randn(1, n, l, d)
        c, s_ = (c_tab, s_tab) if rope else (None, None)
        got = qr.bwd_kernel(x, w, c, s_, gg, n, 1e-6, rope)
        ref = qr.rmsnorm_rope_bwd_plain(x, w, c, s_, gg, n, 1e-6, rope)
        timing = (timed_pair(lambda: qr.bwd_kernel(x, w, c, s_, gg, n, 1e-6, rope),
                             lambda: qr.rmsnorm_rope_bwd_plain(x, w, c, s_, gg, n, 1e-6, rope))
                  if rope else None)
        # x and g in, dx out (bf16), the rope tables; no single PyTorch call
        # computes the fused norm-and-rope backward
        report_many("K7", label, [("dx", got[0], ref[0], 2.0 ** -6),
                                  ("dw", got[1], ref[1], 2.0 ** -7)], results, timing,
                    **bound(3 * l * dim * 2 + 2 * l * d * 4, fp32=12 * l * dim),
                    library_ms=None)
        del x, gg, got, ref

    # K9 with the blocks' bf16 cotangent and the head's fp32 one. Bound:
    # fp32 throughout; the row sums and the 32,760-row ds/dt sums run in
    # another order: 1e-5 of each output's max. ds and dt are summed in a
    # fixed order: dx, ds and dt the same bits on a second call. At batch 1,
    # F.layer_norm(x, (D,), s[0], t[0])'s autograd backward computes the
    # same function: the library call, timed in turns with K9 (and K8's
    # fp32-out instance with F.layer_norm itself).
    x = randn(1, lq, dim, dtype=torch.float32)
    s = 1.0 + 0.1 * torch.randn(1, dim, device=dev, generator=g)
    t_ = 0.1 * torch.randn(1, dim, device=dev, generator=g)
    for label, gdt in (("fp32 g (head)", torch.float32), ("bf16 g (blocks)", torch.bfloat16)):
        gg = randn(1, lq, dim, dtype=gdt)
        got = stream.bwd_kernel(x, s, gg, 1e-6)
        ref = stream.ln_scale_shift_bwd_plain(x, s, gg, 1e-6)
        _k9_same_twice(got, lambda: stream.bwd_kernel(x, s, gg, 1e-6), f"[1, {lq:,}, {dim}] "
                       f"{label}")
        timing = (timed_pair(lambda: stream.bwd_kernel(x, s, gg, 1e-6),
                             lambda: stream.ln_scale_shift_bwd_plain(x, s, gg, 1e-6))
                  if gdt == torch.bfloat16 else None)
        report_many("K9", label, [(o_, a, b, 1e-5)
                                  for o_, a, b in zip(("dx", "ds", "dt"), got, ref)],
                    results, timing,
                    **bound(lq * dim * (4 + gg.element_size() + 4), fp32=12 * lq * dim))
        if timing is not None:
            results["K9"]["library_ms"] = _layer_norm_library(results, "d1536", x, s, t_,
                                                              gg)["K9"]
        del gg, got, ref
    del x
    torch.cuda.empty_cache()
    return route_launches


# K5 at the 81-frame self-attention (12 x 32,760, batch 1), PERF.md's
# kernel table; its dk/dv kernel as ptxas and cuobjdump read it
# when that time was measured. Phase 1 holds the kernel to its registers
# and SASS instruction count: its time alone moves several percent from
# card to card, more than a change to the kernel would have to show
K5_SELF_MS = 33.618
K5_DKV_REGISTERS = 168
K5_DKV_INSTRUCTIONS = 2280
# (tag, B, heads, lq, lk) of every shape the training paths hand K4
K4_SHAPES = (("self", 1, 12, 32760, 32760), ("text", 1, 12, 32760, TEXT_LEN),
             ("image", 1, 12, 9360, 257), ("12k_self", 1, 40, 32760, 32760),
             ("sp4_self", 1, 10, 75600, 75600), ("ring_hop", 2, 10, 37800, 37800))


def _k4_k5_turns(results):
    """K4 and K5 in turns at each shape of K4_SHAPES, the time of each
    beside the bound of the five products; recorded as turns_<tag>_ms.
    K5's time at the self-attention is printed beside K5_SELF_MS, not held
    to it (phase 1 holds K5's code)."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    for tag, b, n, lq, lk in K4_SHAPES:
        q = torch.randn(b, n, lq, 128, device=dev, generator=g).bfloat16()
        k = torch.randn(b, n, lk, 128, device=dev, generator=g).bfloat16()
        v = torch.randn(b, lk, n, 128, device=dev, generator=g).bfloat16()
        o, lse = fa.flash_fwd_kernel(q, k, v, fa.uses_single_block(lk))
        do = torch.randn(o.shape, device=dev, generator=g).bfloat16()
        expect(fa.uses_merged_bwd(lq, lk), f"K4 turns {tag}: the backward takes the split route")
        calls = 1 if lk > TEXT_LEN else 20
        t = timed_turns({"K4": lambda: fa.bwd_kernel(q, k, v, o, lse, do, True),
                         "K5": lambda: fa.bwd_kernel(q, k, v, o, lse, do, False)},
                        reps=3, calls=calls)
        bnd = bound(0, bf16=10 * b * n * lq * lk * 128)["bound_ms"]
        print(f"  K4/K5 turns, {tag} ({b} x {n} x {lq:,} x {lk:,}): K4 {t['K4']:.4f} ms "
              f"({bnd / t['K4']:.3f} of the {bnd:.4f} ms bound), K5 {t['K5']:.4f} ms "
              f"({bnd / t['K5']:.3f}); {CARD}")
        for name in ("K4", "K5"):
            results[name][f"turns_{tag}_ms"] = t[name]
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    ms = results["K5"]["turns_self_ms"]
    print(f"  K5 self-attention {ms:.4f} ms against PERF.md's {K5_SELF_MS} "
          f"({ms / K5_SELF_MS - 1:+.2%}); {CARD}")


def phase_masked_bwd():
    """Phase 5b: K4 and K5 with the key mask against the plain backward at
    the training shapes (batch 1). The gradients of masked keys must be
    exactly 0."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8642)
    n, d = 12, 128
    lq = math.prod(GRID_81)
    valid = 20001
    kvalid = torch.full((n,), valid, dtype=torch.int32, device=dev)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    # o and lse from K2 under the same mask; dO a seeded cotangent. Bound:
    # as the unmasked backward, two bf16 ulps of each gradient's largest
    # entry (2^-6 max|ref|)
    for name, lq_ in (("K4", lq), ("K5", 1024)):
        merged = name == "K4"
        expect(fa.uses_merged_bwd(lq_, lq) == merged, f"{name}: wrong route at lq {lq_}")
        q, k, v = randn(1, n, lq_, d), randn(1, n, lq, d), randn(1, lq, n, d)
        o, lse = fa.flash_fwd_kernel(q, k, v, False, True, kvalid)
        do = randn(*o.shape)
        got = fa.bwd_kernel(q, k, v, o, lse, do, merged, kvalid)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, kvalid)
        report_many(name, f"key mask ({valid:,} of {lq:,} keys, lq {lq_:,})",
                    [(o_, a, b, 2.0 ** -6) for o_, a, b in zip(("dq", "dk", "dv"), got, ref)])
        dk, dv = got[1], got[2]
        zero = not dk[:, :, valid:].any() and not dv[:, valid:].any()
        print(f"  {name} masked keys: dk and dv exactly 0 past key {valid:,}: {zero}")
        expect(zero, f"{name}: masked keys got non-zero gradients")
        expect(dk[:, :, :valid].abs().sum().item() > 0, f"{name}: dk of the kept keys is 0")
        del q, k, v, o, lse, do, got, ref
        torch.cuda.empty_cache()


def phase_grad_model(cfg=None, grid=GRID_9, seed=17, label=""):
    """Phase 6: the output (at phase 3's bound) and the gradients of the
    2-block full-width model (t2v-1.3B unless ``cfg`` says otherwise) on a
    token grid, card against CPU. An i2v/flf2v model also takes seeded
    conditioning ``y`` and CLIP features, whose gradients are held too.
    Returns the seeded state."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    cfg = cfg or wan_dit.t2v_1_3b(num_layers=2, remat_policy="attn")
    i2v = wan_dit.is_i2v(cfg)
    state = from_jax_params(seeded_jax_tree(cfg, seed=seed), cfg)
    rng = np.random.default_rng(seed + 1)
    f, hh, ww = grid[0], grid[1] * 2, grid[2] * 2
    x = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    ctx = rng.standard_normal((1, TEXT_LEN, cfg.text_dim), dtype=np.float32)
    r = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    cond = {}
    if i2v:
        frames = 2 if cfg.model_type == "flf2v" else 1
        cond = {"y": rng.standard_normal((1, f, hh, ww, cfg.in_dim - 16), dtype=np.float32),
                "clip_fea": rng.standard_normal((frames, wan_dit.CLIP_TOKENS, wan_dit.CLIP_DIM),
                                                dtype=np.float32)}
    outs, grads, launches = {}, {}, {}
    # the card and the CPU at bf16 compute, and the CPU at fp32 compute,
    # which measures how far bf16 rounding alone moves each gradient
    for key, dev, cd in (("card", "cuda", torch.bfloat16), ("cpu", "cpu", torch.bfloat16),
                         ("cpu fp32", "cpu", torch.float32)):
        model = wan_dit.WanModel(dataclasses.replace(cfg, compute_dtype=cd),
                                 device=torch.device(dev), param_dtype=torch.float32)
        model.load_state_dict(state)
        xi = torch.from_numpy(x).to(dev).requires_grad_()
        ci = {k: torch.from_numpy(a).to(dev).requires_grad_() for k, a in cond.items()}
        _build.reset_launches()
        t0 = time.perf_counter()
        out = model(xi, torch.tensor([700.0], device=dev), torch.from_numpy(ctx).to(dev), **ci)
        (out * torch.from_numpy(r).to(dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        print(f"  {label}forward + backward, {key}: {time.perf_counter() - t0:.2f} s")
        outs[key] = out.detach().cpu()
        grads[key] = {"input latent": xi.grad.cpu(),
                      **{f"input {k}": a.grad.cpu() for k, a in ci.items()},
                      **{name: p.grad.cpu() for name, p in model.named_parameters()}}
        del model, out, xi, ci

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # phase 3's bound: 3e-2 max|cpu| (bf16 roundings in another order)
    err, rmax, fin = max_err(outs["card"], outs["cpu"])
    print(f"  {label}2-block output: max_abs_err {err:.3e} (bound {3e-2 * rmax:.3e}, "
          f"max|cpu| {rmax:.3e})")
    expect(fin and rmax > 0 and err <= 3e-2 * rmax, f"{label}output: error {err}")

    # Bound: bf16 matmuls and activations round at other points on the card
    # (and K4's dq adds in a run-dependent order), so a gradient may differ
    # from the CPU's bf16 run by a few bf16 ulps of its norm: 2e-2 (about
    # five ulps of 2^-8). The attention k biases (and the image k_img's) are
    # held to the CPU's fp32
    # run instead: their gradient is a sum over keys that nearly cancels
    # (softmax ignores a shift shared by all keys; only the RMSNorm breaks
    # it), so bf16 rounding alone moves it by a large part of its small
    # norm, on the CPU as on the card. The card rounds at as many points as
    # the CPU, so its distance from fp32 may be at most 1.5x the CPU bf16
    # run's; a K4 or K7 fault in that sum moves it further.
    worst = []
    for name, ref in grads["cpu"].items():
        got = grads["card"][name]
        expect(bool(torch.isfinite(got).all()), f"gradient of {name}: non-finite")
        expect(ref.norm().item() > 0, f"gradient of {name} is zero on the CPU")
        if name.endswith((".k.bias", ".k_img.bias")):
            exact = grads["cpu fp32"][name]
            noise, err = rel(ref, exact), rel(got, exact)
            print(f"  {name}: card against CPU fp32 {err:.3e} (bound 1.5 x {noise:.3e}, "
                  f"the CPU bf16 run against fp32); card against CPU bf16 {rel(got, ref):.3e}")
            expect(err <= 1.5 * noise, f"gradient of {name}: card against CPU fp32 {err:.3e} "
                                       f"over 1.5 x {noise:.3e}")
            continue
        err = rel(got, ref)
        worst.append((err, name))
        expect(err <= 2e-2, f"gradient of {name}: relative error {err:.3e} over 2e-2")
    worst.sort(reverse=True)
    print(f"  the other {len(worst)} gradients (every parameter and the input latent"
          f"{', y and the CLIP features' if i2v else ''}) within "
          f"2e-2 of the CPU bf16 run's, relative to their norms; the largest:")
    for err, name in worst[:5]:
        print(f"    {name}: {err:.3e}")
    want = dit_launches(cfg.num_layers, True,
                        self_single=fa.uses_single_block(math.prod(grid)), i2v=i2v)
    print(f"  {label}launches {launches}, derived {want}")
    expect(launches == want, f"{label}launches {launches}, expected {want}")
    torch.cuda.empty_cache()
    return state


GRID_14B_81 = (21, 45, 80)  # token grid of an 81-frame 720*1280 request (75,600)
GRID_14B_1 = (1, 30, 52)    # one latent frame at 832*480 (1,560 tokens)
GRID_BENCH = (8, 15, 26)    # bench.py's token grid (3,120)


def _norm_kernels_at(results, tag, n, grid, g, shard=1):
    """K6-K9 against their plain versions at [1, prod(grid) / shard, 128 n]
    with n heads (``shard`` > 1: the first sequence-parallel rank's block of
    the tokens, its rope rows), timed beside their byte bounds, K7's and
    K9's outputs bitwise equal on a second call, and K8 (fp32 out) and K9
    in turns with F.layer_norm and its backward, the one PyTorch call of
    their function at batch 1; recorded under ``tag``."""
    import torch

    from hyvideo_prfl_torch.models.rope import rope_tables_rolled_np
    from hyvideo_prfl_torch.ops import qknorm_rope as qr
    from hyvideo_prfl_torch.ops import stream

    dev = torch.device("cuda")
    # Bounds, as at width 1536 (phases 2 and 5): K8 one bf16 ulp of max|out|;
    # K9 1e-5 of each output's max; K6 and K7's dx two bf16 ulps, K7's dw
    # one. Byte bounds: each input read once, each output written once.
    l, dim = math.prod(grid) // shard, n * 128
    x32 = torch.randn(1, l, dim, device=dev, generator=g)
    s_ = 1.0 + 0.1 * torch.randn(1, dim, device=dev, generator=g)
    t_ = 0.1 * torch.randn(1, dim, device=dev, generator=g)
    g32 = torch.randn(1, l, dim, device=dev, generator=g).bfloat16()
    xb = torch.randn(1, l, dim, device=dev, generator=g).bfloat16()
    w = 1.0 + 0.1 * torch.randn(dim, device=dev, generator=g)
    c_tab, s_tab = (torch.from_numpy(a[:l]).to(dev) for a in rope_tables_rolled_np(grid, 128))
    gh = torch.randn(1, n, l, 128, device=dev, generator=g).bfloat16()
    tables = 2 * l * 128 * 4
    cases = {
        "K8": (lambda: stream._kernel(x32, s_, t_, 1e-6, torch.bfloat16),
               lambda: stream.ln_scale_shift_plain(x32, s_, t_, 1e-6, torch.bfloat16),
               (("out", 2.0 ** -7),), l * dim * (4 + 2)),
        "K9": (lambda: stream.bwd_kernel(x32, s_, g32, 1e-6),
               lambda: stream.ln_scale_shift_bwd_plain(x32, s_, g32, 1e-6),
               (("dx", 1e-5), ("ds", 1e-5), ("dt", 1e-5)), l * dim * (4 + 2 + 4)),
        "K6": (lambda: qr._kernel(xb, w, c_tab, s_tab, n, 1e-6, True),
               lambda: qr.rmsnorm_rope_plain(xb, w, c_tab, s_tab, n, 1e-6, True),
               (("out", 2.0 ** -6),), l * dim * (2 + 2) + tables),
        "K7": (lambda: qr.bwd_kernel(xb, w, c_tab, s_tab, gh, n, 1e-6, True),
               lambda: qr.rmsnorm_rope_bwd_plain(xb, w, c_tab, s_tab, gh, n, 1e-6, True),
               (("dx", 2.0 ** -6), ("dw", 2.0 ** -7)), l * dim * 3 * 2 + tables),
    }
    for name, (kern, plain, outs, nbytes) in cases.items():
        got, ref = kern(), plain()
        got, ref = ((got, ref) if isinstance(got, tuple) else ((got,), (ref,)))
        if name == "K7":
            # dw is summed in a fixed order: the same bits on a second call
            # (a bitwise resume on the card relies on it)
            same = all(torch.equal(a, b) for a, b in zip(got, kern()))
            print(f"  K7 [1, {l:,}, {dim}]: dx and dw bitwise equal on a second call: {same}")
            expect(same, f"K7 at [1, {l}, {dim}] is not deterministic")
        elif name == "K9":
            _k9_same_twice(got, kern, f"[1, {l:,}, {dim}]")
        worst = 0.0
        for (out_name, rel_bound), a, b in zip(outs, got, ref):
            err, rmax, fin = max_err(a, b)
            print(f"  {name} [1, {l:,}, {dim}] {out_name}: max_abs_err {err:.3e} "
                  f"(bound {rel_bound * rmax:.3e}, max|ref| {rmax:.3e})")
            expect(fin and err <= rel_bound * rmax,
                   f"{name} at [1, {l}, {dim}]: {out_name} error {err}")
            worst = max(worst, err)
        del got, ref
        ms, pms = timed_pair(kern, plain)
        bd = bound(nbytes)["bound_ms"]
        print(f"  {name} [1, {l:,}, {dim}]: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bd:.4f} ms (bytes), {bd / ms:.3f} of the bound")
        results[name].update({f"{tag}_ms": ms, f"{tag}_plain_ms": pms,
                              f"{tag}_bound_ms": bd, f"{tag}_max_abs_err": worst})

    _layer_norm_library(results, tag, x32, s_, t_, g32)
    del x32, g32, xb, gh, cases
    torch.cuda.empty_cache()


def _k9_same_twice(got, kern, label):
    """K9 sums ds and dt in an order fixed by the shapes and the SM count:
    dx, ds and dt the same bits on a second call (a bitwise resume on the
    card relies on it)."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(got, kern()))
    print(f"  K9 {label}: dx, ds and dt bitwise equal on a second call: {same}")
    expect(same, f"K9 at {label} is not deterministic")


def _layer_norm_library(results, tag, x32, s_, t_, g):
    """K8's fp32-out instance and K9 in turns with their library call at
    batch 1, recorded under ``tag``: F.layer_norm with weight s[0] and
    bias t[0] computes K8's function (fp32 in, fp32 out), and its autograd
    backward K9's (dx, ds, dt; it takes the cotangent in fp32, K9 reads
    g as given). Neither is used by the port; their outputs are held to the
    plain versions' at K8's and K9's bounds, so the time is of the same
    function. Returns {"K8": ms, "K9": ms} of the library calls."""
    import torch
    import torch.nn.functional as F

    from hyvideo_prfl_torch.ops import stream

    l, dim = x32.shape[1:]
    xr = x32.clone().requires_grad_()
    sr, tr = s_[0].clone().requires_grad_(), t_[0].clone().requires_grad_()
    yr = F.layer_norm(xr, (dim,), sr, tr, 1e-6)
    gf = g.float()
    lib8 = F.layer_norm(x32, (dim,), s_[0], t_[0], 1e-6)
    ref8 = stream.ln_scale_shift_plain(x32, s_, t_, 1e-6, torch.float32)
    e8, m8, _ = max_err(lib8, ref8)
    lib9 = torch.autograd.grad(yr, (xr, sr, tr), gf, retain_graph=True)
    ref9 = stream.ln_scale_shift_bwd_plain(x32, s_, g, 1e-6)
    e9 = [max_err(a, b.reshape(a.shape)) for a, b in zip(lib9, ref9)]
    del lib8, ref8, lib9, ref9
    expect(e8 <= 2.0 ** -7 * m8 and all(e <= 1e-5 * m for e, m, _ in e9),
           f"F.layer_norm at [1, {l}, {dim}] computes another function: {e8}, {e9}")
    t8 = timed_turns({"kernel": lambda: stream._kernel(x32, s_, t_, 1e-6, torch.float32),
                      "library": lambda: F.layer_norm(x32, (dim,), s_[0], t_[0], 1e-6)})
    t9 = timed_turns({"kernel": lambda: stream.bwd_kernel(x32, s_, g, 1e-6),
                      "library": lambda: torch.autograd.grad(yr, (xr, sr, tr), gf,
                                                             retain_graph=True)})
    b8 = bound(l * dim * 8)["bound_ms"]
    b9 = bound(l * dim * (4 + g.element_size() + 4))["bound_ms"]
    print(f"  K8 [1, {l:,}, {dim}] fp32 out: kernel {t8['kernel']:.4f} ms, F.layer_norm "
          f"{t8['library']:.4f} ms (bound {b8:.4f} ms); K9: kernel {t9['kernel']:.4f} ms "
          f"({b9 / t9['kernel']:.3f} of its bound), F.layer_norm's backward "
          f"{t9['library']:.4f} ms; {CARD}")
    expect(t9["kernel"] <= t9["library"],
           f"K9 at [1, {l}, {dim}] is slower than F.layer_norm's backward: {t9}")
    results.setdefault("K8", {}).update({f"{tag}_fp32_ms": t8["kernel"],
                                         f"{tag}_fp32_bound_ms": b8,
                                         f"{tag}_library_ms": t8["library"]})
    results.setdefault("K9", {}).update({f"{tag}_library_ms": t9["library"],
                                         f"{tag}_in_library_turns_ms": t9["kernel"]})
    del xr, sr, tr, yr, gf
    return {"K8": t8["library"], "K9": t9["library"]}


def phase_wide(results):
    """Phase 10: the 14B width. K6-K9 against their plain versions at
    [1, 75,600, 5120] with 40 heads (t2v-14B at 720*1280, 81 frames) and
    at [1, 3,120, 1280] with 10 heads (bench.py's shape), timed beside
    their byte bounds; K1 and K2 against theirs at 40 heads x 18,900 and
    10 and 5 heads x 75,600; a 1-block t2v-14B model's output and gradients,
    card against CPU, at one latent frame of 832*480; the same block
    forward and backward at 720*1280 and 81 frames on the card, gradients
    finite and launches as derived."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9876)
    for tag, n, grid in (("d5120", 40, GRID_14B_81), ("d1280", 10, GRID_BENCH)):
        _norm_kernels_at(results, tag, n, grid, g)

    # K1 and K2 at the 14B self-attention's sequence-parallel shards: 40
    # heads x 18,900 tokens, and 10 or 5 heads x 75,600 (unit-variance q/k
    # for the qk-normed activations). The last key tile holds 84 and 80
    # keys; the persistent grid takes 5,920, 5,910 and 2,955 tiles. Bounds
    # as phases 2 and 2b: o within two bf16 ulps of max|o|, lse 1e-5
    # max|lse|.
    for n, l in ((40, 18900), (10, 75600), (5, 75600)):
        q = torch.randn(1, n, l, 128, device=dev, generator=g).bfloat16()
        k = torch.randn(1, n, l, 128, device=dev, generator=g).bfloat16()
        v = torch.randn(1, l, n, 128, device=dev, generator=g).bfloat16()
        vt = v.movedim(1, 2).contiguous()
        flop = 4 * n * l * l * 128
        bnd = bound(4 * n * l * 128 * 2, bf16=flop)["bound_ms"]
        for name, shifted, plain in (("K1", False, fa.flash_attention_plain),
                                     ("K2", True, fa.flash_attention_shifted_plain)):
            o, lse = fa.flash_fwd_kernel(q, k, v, False, shifted)
            po, plse = plain(q, k, v)
            err, rmax, fin = max_err(o, po)
            el, ml, fl = max_err(lse, plse)
            del o, lse, po, plse
            expect(fin and err <= 2.0 ** -6 * rmax,
                   f"{name} at {n} heads x {l}: error {err} over {2.0 ** -6 * rmax}")
            expect(fl and el <= 1e-5 * ml, f"{name} at {n} heads x {l}: lse error {el}")
            t = timed_turns({"kernel": lambda: fa.flash_fwd_kernel(q, k, v, False, shifted),
                             "library": lambda: sdpa_flash(q, k, vt)}, reps=3, calls=2)
            print(f"  {name} [1, {n}, {l:,}, 128]: max_abs_err {err:.3e} (bound "
                  f"{2.0 ** -6 * rmax:.3e}), lse {el:.3e} (bound {1e-5 * ml:.3e}); kernel "
                  f"{t['kernel']:.4f} ms ({flop / (t['kernel'] * 1e9):.1f} TFLOP/s, "
                  f"{bnd / t['kernel']:.3f} of the {bnd:.4f} ms bound), SDPA flash "
                  f"{t['library']:.4f} ms")
            tag = f"h{n}_l{l}"
            results[name].update({f"{tag}_ms": t["kernel"], f"{tag}_library_ms": t["library"],
                                  f"{tag}_bound_ms": bnd, f"{tag}_max_abs_err": err})
        del q, k, v, vt
        torch.cuda.empty_cache()

    # a block of t2v-14B (dim 5120, 40 heads, ffn 13,824), remat "attn" as
    # the training path runs it: output and gradients, card against CPU (one
    # block: the check's CPU half is the slow part of this phase)
    cfg = wan_dit.t2v_14b(num_layers=1, remat_policy="attn")
    state = phase_grad_model(cfg, GRID_14B_1, seed=41, label="t2v-14B 1 block, 1,560 tokens: ")

    # the same block at 720*1280, 81 frames (75,600 tokens), on the card
    model = wan_dit.WanModel(cfg, device=dev, param_dtype=torch.float32)
    model.load_state_dict(state)
    del state
    f, hh, ww = GRID_14B_81[0], GRID_14B_81[1] * 2, GRID_14B_81[2] * 2
    x = torch.randn(1, f, hh, ww, 16, device=dev, generator=g).requires_grad_()
    ctx = torch.randn(1, TEXT_LEN, cfg.text_dim, device=dev, generator=g)
    r = torch.randn(1, f, hh, ww, 16, device=dev, generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = model(x, torch.tensor([700.0], device=dev), ctx)
    (out * r).sum().backward()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = [name for name, p in model.named_parameters() if not bool(torch.isfinite(p.grad).all())]
    print(f"  t2v-14B 1 block, 720*1280, 81 frames ({math.prod(GRID_14B_81):,} tokens): "
          f"forward + backward {dt:.3f} s, peak {peak:.2f} GiB, launches {launches}")
    expect(tuple(out.shape) == (1, f, hh, ww, 16), f"t2v-14B output {tuple(out.shape)}")
    expect(bool(torch.isfinite(out).all()), "t2v-14B output is not finite")
    expect(not bad and bool(torch.isfinite(x.grad).all()),
           f"t2v-14B gradients not finite: {bad[:5]}")
    want = dit_launches(cfg.num_layers, True)
    expect(launches == want, f"t2v-14B launches {launches}, expected {want}")
    del model, out, x, ctx, r
    torch.cuda.empty_cache()


def phase_unnormed():
    """Phase 9: the un-normed DiT (qk_norm off) at t2v-1.3B width: a
    1-block card-against-CPU check of the output and every gradient on the
    9-frame grid, then a 30-block batched-CFG forward at 81 frames through
    the pipeline; returns the pipeline's launches."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.pipelines.pipeline import GenerateConfig, WanT2V
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    # no qk-norm and no norm3 (no K6, K7 or norm3 K8/K9: R, K2 and K3s in
    # their place), remat "full" (the training path runs "attn")
    # 1 block (cut from 2 for phase 17's room)
    cfg = wan_dit.t2v_1_3b(num_layers=1, qk_norm=False, cross_attn_norm=False,
                           remat_policy="full")
    state = from_jax_params(seeded_jax_tree(cfg, seed=31), cfg)
    rng = np.random.default_rng(32)
    f, hh, ww = GRID_9[0], GRID_9[1] * 2, GRID_9[2] * 2
    x = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    ctx = rng.standard_normal((1, TEXT_LEN, cfg.text_dim), dtype=np.float32)
    r = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    outs, grads, launches = {}, {}, {}
    for key, dev, cd in (("card", "cuda", torch.bfloat16), ("cpu", "cpu", torch.bfloat16),
                         ("cpu fp32", "cpu", torch.float32)):
        model = wan_dit.WanModel(dataclasses.replace(cfg, compute_dtype=cd),
                                 device=torch.device(dev), param_dtype=torch.float32)
        model.load_state_dict(state)
        xi = torch.from_numpy(x).to(dev).requires_grad_()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = model(xi, torch.tensor([700.0], device=dev), torch.from_numpy(ctx).to(dev))
        (out * torch.from_numpy(r).to(dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        print(f"  un-normed forward + backward, {key}: {time.perf_counter() - t0:.2f} s")
        outs[key] = out.detach().cpu()
        grads[key] = {"input latent": xi.grad.cpu(),
                      **{name: p.grad.cpu() for name, p in model.named_parameters()}}
        del model, out, xi

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # Output bound: 3e-2 max|cpu|, phase 3's (bf16 roundings in another order)
    err, rmax, fin = max_err(outs["card"], outs["cpu"])
    print(f"  un-normed 1-block output: max_abs_err {err:.3e} (bound {3e-2 * rmax:.3e}, "
          f"max|cpu| {rmax:.3e})")
    expect(fin and rmax > 0 and err <= 3e-2 * rmax, f"un-normed output: error {err}")
    # Gradient bounds, phase 6's: 2e-2 of each norm against the CPU bf16
    # run; the k biases, whose gradients are near-cancelling sums over keys,
    # against the CPU fp32 run at 1.5x the CPU bf16 run's distance from it.
    # Without qk-norm the cross-attention k bias shifts every logit of a row
    # alike and the softmax ignores it: its gradient is 0 up to rounding on
    # every run, so both distances measure rounding noise alone; its bound
    # is 2x (the noise norms of two runs agree only to a factor).
    worst = []
    for name, ref in grads["cpu"].items():
        got = grads["card"][name]
        expect(bool(torch.isfinite(got).all()), f"un-normed gradient of {name}: non-finite")
        if name.endswith(".k.bias"):
            exact = grads["cpu fp32"][name]
            noise, e = rel(ref, exact), rel(got, exact)
            factor = 2.0 if "cross_attn" in name else 1.5
            print(f"  {name}: card against CPU fp32 {e:.3e} (bound {factor} x {noise:.3e}, the "
                  f"CPU bf16 run against fp32; norms card {got.norm():.3e}, CPU bf16 "
                  f"{ref.norm():.3e}, fp32 {exact.norm():.3e})")
            expect(e <= factor * noise, f"un-normed gradient of {name}: {e} over "
                                        f"{factor} x {noise}")
            continue
        expect(ref.norm().item() > 0, f"un-normed gradient of {name} is zero on the CPU")
        e = rel(got, ref)
        worst.append((e, name))
        expect(e <= 2e-2, f"un-normed gradient of {name}: relative error {e:.3e} over 2e-2")
    worst.sort(reverse=True)
    print(f"  the other {len(worst)} gradients within 2e-2 of the CPU bf16 run's; the largest: "
          + ", ".join(f"{name} {e:.3e}" for e, name in worst[:3]))
    want = dit_launches(cfg.num_layers, True, remat_policy="full", qk_norm=False,
                        cross_attn_norm=False)
    print(f"  launches {launches}, derived {want}")
    expect(launches == want, f"un-normed launches {launches}, expected {want}")

    # 30 blocks at 81 frames: one batched-CFG forward pair through the
    # pipeline (one UniPC step), random seeded weights with a seeded head
    dev = torch.device("cuda")
    cfg = wan_dit.t2v_1_3b(qk_norm=False)
    model = wan_dit.init_params(wan_dit.WanModel(cfg, device=dev),
                                torch.Generator(device=dev).manual_seed(33))
    with torch.no_grad():
        model.head.head.weight.normal_(0.0, cfg.dim ** -0.5,
                                       generator=torch.Generator(device=dev).manual_seed(34))
    pipe = WanT2V(model.eval())
    g = torch.Generator(device=dev).manual_seed(35)
    context = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev)
    lat_grid = (GRID_81[0], GRID_81[1] * 2, GRID_81[2] * 2)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    lat = pipe.generate(g, context, torch.zeros_like(context), *lat_grid,
                        gen=GenerateConfig(sampling_steps=1, guide_scale=5.0, shift=5.0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = dit_launches(cfg.num_layers, False, qk_norm=False)
    print(f"  un-normed 30 blocks, 81 frames, one forward pair: {dt:.3f} s, latents "
          f"{tuple(lat.shape)}, launches {launches} (derived {want})")
    expect(tuple(lat.shape) == (1, *lat_grid, 16), f"un-normed latents {tuple(lat.shape)}")
    expect(bool(torch.isfinite(lat).all()), "un-normed latents are not finite")
    expect(launches == want, f"un-normed pipeline launches {launches}, expected {want}")
    del pipe, model, lat
    torch.cuda.empty_cache()
    return launches


def published(name, changes=None):
    """configs/<name> as the CLIs read it (load_config: the port's own YAML
    reader, merged over the defaults), with ``changes`` ({"section.key":
    value}) applied on top."""
    from hyvideo_prfl_torch.configs import load_config

    config = load_config(os.path.join(REPO, "configs", name))
    for path, value in (changes or {}).items():
        *parents, leaf = path.split(".")
        node = config
        for part in parents:
            node = node.setdefault(part, type(config)())
        node[leaf] = value
    return config


# The smoke's changes to configs/train_prfl_{t2v,i2v}_480.yaml: the 1.3B
# width, 8 PRFL steps with a fixed mid step, no accumulation, no weights
PRFL_CHANGES = {
    "prfl_inference_steps": 8,               # added: 8 steps
    "model.base_path": None,                 # no weights in the repository
    "train.gradient_accumulation_steps": 1,  # changed from 5
    "train.fixed_mid": 3,                    # added
}
PRFL_T2V = ("train_prfl_t2v_480.yaml", {**PRFL_CHANGES, "task": "t2v-1.3b"})  # from t2v-14b
PRFL_I2V = ("train_prfl_i2v_480.yaml", {**PRFL_CHANGES, "task": "i2v-1.3b"})  # from i2v-14b-480p


def yaml_text(tree, indent=0) -> str:
    """A config tree as YAML in the subset the configs use (block mappings;
    scalars and flow lists; strings JSON-quoted, floats with a dot), for a
    CLI's --config_path."""
    def scalar(v):
        if isinstance(v, list):
            return "[" + ", ".join(scalar(x) for x in v) + "]"
        if v is None or isinstance(v, bool):
            return {None: "null", True: "true", False: "false"}[v]
        if isinstance(v, float):
            if math.isinf(v) or math.isnan(v):
                return {math.inf: ".inf", -math.inf: "-.inf"}.get(v, ".nan")
            mant, _, exp = repr(v).partition("e")
            return mant + ("" if "." in mant else ".0") + (f"e{exp}" if exp else "")
        return str(v) if isinstance(v, int) else json.dumps(v)

    lines = []
    for key, value in tree.items():
        if isinstance(value, dict):
            expect(bool(value), f"yaml_text: the empty mapping {key} has no block form")
            lines += [" " * indent + f"{key}:", yaml_text(value, indent + 2)]
        else:
            lines.append(" " * indent + f"{key}: {scalar(value)}")
    return "\n".join(lines)


def write_latent_cache(root, frame_counts, i2v=False):
    """A seeded latent cache in the reference's layout (temp_data_smoke/) at
    the slice's shapes: latents [1, 16, F, 60, 104], text [1, n, 4096]; with
    ``i2v`` also the first-frame condition latent (f1_black_path, as
    latents) and the CLIP features (imgclip_path, [1, 257, 1280]), drawn
    after each clip's other draws. Returns {frames: meta list path}."""
    rng = np.random.default_rng(21)
    null_dir = os.path.join(root, "null", "wanx")
    os.makedirs(null_dir)
    os.makedirs(os.path.join(root, "latents"))
    np.save(os.path.join(null_dir, "null.npy"), rng.standard_normal((1, 1, 4096), np.float32))
    np.save(os.path.join(null_dir, "uncond.npy"),
            rng.standard_normal((1, 20, 4096), np.float32))
    lists = {}
    for frames in frame_counts:
        lat_f = (frames - 1) // 4 + 1
        stem = os.path.join(root, "latents", f"clip{frames}")
        meta = {"vae_latent_path": stem + ".npy", "textshort_path": stem + "_short.npy",
                "textlong_path": stem + "_long.npy", "short_caption": f"clip {frames}",
                "long_caption": f"a longer caption for clip {frames}"}
        np.save(meta["vae_latent_path"],
                rng.standard_normal((1, 16, lat_f, 60, 104), np.float32))
        np.save(meta["textshort_path"], rng.standard_normal((1, 12, 4096), np.float32))
        np.save(meta["textlong_path"], rng.standard_normal((1, 48, 4096), np.float32))
        if i2v:
            meta.update(f1_black_path=stem + "_cond.npy", imgclip_path=stem + "_clip.npy")
            np.save(meta["f1_black_path"],
                    rng.standard_normal((1, 16, lat_f, 60, 104), np.float32))
            np.save(meta["imgclip_path"], rng.standard_normal((1, 257, 1280), np.float32))
        meta_path = stem + "_meta.json"
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        lists[frames] = stem + ".list"
        with open(lists[frames], "w") as f:
            f.write(meta_path + "\n")
    return lists, os.path.join(root, "null")


def load_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _build_trainer(cli, config, dev):
    """The trainer of a config, with the head seeded as the JAX
    initialisers would not (a zero head gives every block a zero gradient
    in the first refl step)."""
    import torch

    t0 = time.perf_counter()
    trainer = cli.build_trainer(config, dev.type)
    with torch.no_grad():
        trainer.model.dit.head.head.weight.normal_(
            0.0, trainer.model.dit_cfg.dim ** -0.5,
            generator=torch.Generator(device=dev).manual_seed(12))
    torch.cuda.synchronize()
    return trainer, config, time.perf_counter() - t0


def phase_train(root):
    """Phase 7: PRFL training through the CLI path, with the bf16 and the
    int8 rollout, then one step on the shifted route and one with the split
    backward K5; returns the launch counts of all."""
    import torch

    from hyvideo_prfl_torch.data.dataset import LatentCacheDataset
    from hyvideo_prfl_torch.data.loader import BatchIterator, BlockDistributedSampler
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa

    cli = load_script("train_prfl_torch")
    lists, null_dir = write_latent_cache(root, (21, 81))
    cfg_name, changes = PRFL_T2V
    changes = {**changes, "dataset.meta_file_list": [lists[21]], "dataset.null_dir": null_dir,
               "save.output_dir": os.path.join(root, "out")}
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    trainer, config, build_s = _build_trainer(cli, published(cfg_name, changes), dev)
    model = trainer.model
    cfg = model.dit_cfg
    n_lrm = model.lrm.dit_cfg.num_layers
    print(f"  trainer built in {build_s:.2f} s: policy "
          f"{sum(p.numel() for p in model.dit.parameters()) / 1e9:.3f} B fp32 master params, "
          f"{cfg.num_layers} blocks; LRM {n_lrm} blocks, frozen; it holds "
          f"{(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held before it")
    watched = {name: p.detach().clone() for name, p in model.dit.named_parameters()
               if name in ("blocks.0.ffn_0.weight", "blocks.29.self_attn.q.weight",
                           "blocks.15.modulation", "blocks.0.self_attn.norm_q")}
    lrm_before = model.lrm.mlp.Dense_0.weight.detach().clone()
    per_step = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                       cfg.remat_policy)

    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    hist = cli.run(trainer, 2)
    torch.cuda.synchronize()
    got = dict(_build.LAUNCHES)
    want = _add({}, per_step, 2)
    for m in hist:
        print(f"  21 frames (9,360 tokens), step {m['step']}: refl_loss {m['refl_loss']:.6f}, "
              f"reward {m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss "
              f"{m['sft_loss']:.6f}, t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s")
        for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
            expect(math.isfinite(m[key]), f"{key} is not finite: {m}")
        expect(m["grad_norm"] > 0, f"grad norm {m['grad_norm']} is not above 0")
    for name, before in watched.items():
        p = dict(model.dit.named_parameters())[name]
        moved = (p.detach() != before).float().mean().item()
        print(f"  {name}: {moved:.1%} of its entries moved")
        expect(moved > 0, f"policy weight {name} did not move")
    expect(torch.equal(model.lrm.mlp.Dense_0.weight, lrm_before), "the frozen LRM moved")
    print(f"  launches over 2 outer steps {got}, derived {want} (per step {per_step})")
    expect(got == want, f"launches {got}, expected {want}")
    print(f"  peak device memory at 21 frames {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} above what was held "
          f"before the trainer; {CARD}")

    ds81 = LatentCacheDataset([lists[81]], uncond_prob=[0.1, 0.0], text_len=512,
                              null_dir=null_dir, seed=1)
    trainer.loader = iter(BatchIterator(ds81, BlockDistributedSampler(len(ds81))))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (m,) = cli.run(trainer, 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    got = dict(_build.LAUNCHES)
    want = _add({}, per_step, 3)
    print(f"  81 frames (32,760 tokens): refl_loss {m['refl_loss']:.6f}, reward "
          f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
          f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s")
    print(f"  peak device memory at 81 frames {peak / 2**30:.2f} GiB "
          f"({peak / 1e9:.2f} GB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB), "
          f"{(peak - held) / 2**30:.2f} GiB above what was held before the trainer; {CARD}")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"{key} is not finite at 81 frames: {m}")
    expect(peak < 80e9, f"peak memory {peak} does not fit 80 GB")
    expect(got == want, f"launches over 3 outer steps {got}, expected {want}")
    first_reward = hist[0]["reward"]
    del trainer, model
    torch.cuda.empty_cache()

    # The int8 rollout, from the same weights and draws: one outer step at
    # 21 frames and one at 81, each with the counters set to 0 just before.
    trainer, config, build_s = _build_trainer(
        cli, published(cfg_name, {**changes, "train.rollout_quant": "int8"}), dev)
    print(f"  int8-rollout trainer built in {build_s:.2f} s")
    per_step8 = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                        cfg.remat_policy, rollout_quant="int8")
    got8 = {}
    for frames in (21, 81):
        if frames == 81:
            trainer.loader = iter(BatchIterator(ds81, BlockDistributedSampler(len(ds81))))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        (m,) = cli.run(trainer, 1)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"  int8 rollout, {frames} frames: refl_loss {m['refl_loss']:.6f}, reward "
              f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
              f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
        for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
            expect(math.isfinite(m[key]), f"{key} is not finite with the int8 rollout: {m}")
        expect(m["grad_norm"] > 0, f"grad norm {m['grad_norm']} is not above 0")
        expect(launches == per_step8, f"int8 rollout launches {launches}, expected {per_step8}")
        if frames == 21:
            # the same weights, data and draws as the bf16 run's first step:
            # only the rollout's quantization moves the reward (the bound of
            # tests/test_learning_dynamics.py:392)
            d = abs(m["reward"] - first_reward)
            print(f"  first reward, int8 rollout against bf16: {m['reward']:.6f} against "
                  f"{first_reward:.6f} ({d:.2e}, bound 0.05)")
            expect(d <= 0.05, f"the int8 rollout's first reward lies {d} from the bf16 run's")
        _add(got8, launches)
    del trainer
    torch.cuda.empty_cache()

    # The shifted route (HYV_FLASH_BOUNDED=0), from the same weights, data
    # and draws: one outer step at 21 frames through K2 and K3s. Bound on
    # the first reward: the routes differ only in where bf16 rounds p, so
    # the reward moves far less than under the int8 rollout (bound 0.05
    # above): 0.01.
    fa.FLASH_BOUNDED = False
    try:
        trainer, config, build_s = _build_trainer(cli, published(cfg_name, changes), dev)
        per_step_s = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                             cfg.remat_policy, shifted=True)
        name = "blocks.29.self_attn.q.weight"
        before = dict(trainer.model.dit.named_parameters())[name].detach().clone()
        torch.cuda.synchronize()
        _build.reset_launches()
        (m,) = cli.run(trainer, 1)
        torch.cuda.synchronize()
        got_s = dict(_build.LAUNCHES)
    finally:
        fa.FLASH_BOUNDED = True
    moved = (dict(trainer.model.dit.named_parameters())[name].detach() != before).float().mean()
    print(f"  shifted route, 21 frames: refl_loss {m['refl_loss']:.6f}, reward "
          f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
          f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s (a fresh trainer's first "
          f"step); {name}: {moved.item():.1%} moved; launches {got_s}")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"{key} is not finite on the shifted route: {m}")
    expect(m["grad_norm"] > 0 and moved.item() > 0, "the shifted route's step moved nothing")
    expect(got_s == per_step_s, f"shifted route launches {got_s}, expected {per_step_s}")
    d = abs(m["reward"] - first_reward)
    print(f"  first reward, shifted route against bounded: {m['reward']:.6f} against "
          f"{first_reward:.6f} ({d:.2e}, bound 0.01)")
    expect(d <= 0.01, f"the shifted route's first reward lies {d} from the bounded run's")
    del trainer
    torch.cuda.empty_cache()

    # Every backward on K5 (HYV_FLASH_MERGED_BWD=0), from the same weights,
    # data and draws: one outer step at 21 frames. The forward is the bf16
    # run's, so its first reward is too (bound 0.01, as the shifted
    # route's); the gradients differ from K4's in where dq rounds, so the
    # grad norm stays within 1% of the bf16 run's.
    fa.FLASH_MERGED_BWD = False
    try:
        trainer, config, build_s = _build_trainer(cli, published(cfg_name, changes), dev)
        per_step_k5 = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                              cfg.remat_policy, merged_bwd=False)
        torch.cuda.synchronize()
        _build.reset_launches()
        (m,) = cli.run(trainer, 1)
        torch.cuda.synchronize()
        got_k5 = dict(_build.LAUNCHES)
    finally:
        fa.FLASH_MERGED_BWD = True
    print(f"  split backward (K5), 21 frames: refl_loss {m['refl_loss']:.6f}, reward "
          f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
          f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s (a fresh trainer's first "
          f"step); launches {got_k5}")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"{key} is not finite with the split backward: {m}")
    expect(got_k5 == per_step_k5, f"split backward launches {got_k5}, expected {per_step_k5}")
    d = abs(m["reward"] - first_reward)
    g = abs(m["grad_norm"] / hist[0]["grad_norm"] - 1)
    print(f"  first step, split backward against merged: reward {d:.2e} apart (bound 0.01), "
          f"grad norm {m['grad_norm']:.6e} against {hist[0]['grad_norm']:.6e} ({g:.2e} "
          f"relative, bound 0.01)")
    expect(d <= 0.01 and g <= 0.01, "the split backward's first step strays from the merged one's")
    del trainer
    torch.cuda.empty_cache()
    return _add(_add(_add(got, got8), got_s), got_k5)


def phase_probes(results):
    """Phase 8: the int8 probes P1 and P2 through their scripts, each with
    the counters set to 0 just before; returns their launches."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    launches = {}
    for name, script, shown in (("P1", "probe_int8_rate_torch", "qk"),
                                ("P2", "probe_int8_mosaic_torch", "chain")):
        cli = load_script(script)
        _build.reset_launches()
        res = cli.main([])
        torch.cuda.synchronize()
        launches[name] = _build.LAUNCHES[name]
        for r in res:
            print(f"  {name} {r['probe']} [{r['m']}, {r['k']}] x [{r['k']}, {r['n_cols']}] x "
                  f"{r['nblocks']} blocks x {r['reps']} reps (clusters of {r['cluster']}): "
                  f"int8 {r['int8_ms']:.4f} ms "
                  f"{r['int8_tops']:.1f} TOPS (torch._int_mm {r['int8_library_tops']:.1f}), "
                  f"bf16 {r['bf16_ms']:.4f} ms {r['bf16_tops']:.1f} TFLOP/s (torch.matmul "
                  f"{r['bf16_library_tops']:.1f}), int8 {r['int8_over_bf16']:.2f}x bf16; exact "
                  f"{r['int8_exact']}/{r['bf16_exact']}")
            expect(r["int8_exact"] and r["bf16_exact"],
                   f"{name} {r['probe']} differs from its plain version")
        r = next(r for r in res if r["probe"] == shown)
        ops = 2 * r["m"] * r["k"] * r["n_cols"] * r["nblocks"] * r["reps"]
        nbytes = r["m"] * r["k"] + r["nblocks"] * r["n_cols"] * r["k"] + 4 * r["m"] * r["n_cols"]
        # no single PyTorch call sums the reps and the b-blocks: library_ms
        # is null; the library's rate for one rep's product is printed above
        results[name] = {"max_abs_err": 0.0, "ms": r["int8_ms"], "plain_ms": r["plain_ms"],
                         **bound(nbytes, int8=ops), "library_ms": None,
                         "bf16_ms": r["bf16_ms"], "int8_tops": r["int8_tops"],
                         "bf16_tops": r["bf16_tops"]}
    return launches


def phase_i2v(results, root):
    """Phase 11: i2v and flf2v. K3 at the image cross-attention's shapes and
    K4 at its training shape; 1 i2v-14B block card against CPU (output and
    every gradient) and 2 flf2v-14B blocks (output); i2v-14B and flf2v-14B
    served at full width and depth through the CLI path; one i2v PRFL outer
    step through the training CLI. Returns the launches of serving and
    training."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    # K3 at the image cross-attention of an 81-frame 832*480 CFG-2 forward of
    # a 14B model: 40 heads x 32,760 queries over 257 CLIP tokens (i2v; one
    # key past two 128-key tiles) and 514 (flf2v; two past four). Bounds as
    # phase 2: o within two bf16 ulps of max|o|, lse 1e-5 max|lse|.
    b, n, d = 2, 40, 128
    lq = math.prod(GRID_81)
    q = randn(b, n, lq, d)
    for lk in (257, 514):
        k, v = randn(b, n, lk, d), randn(b, lk, n, d)
        expect(fa.uses_single_block(lk), f"K3: lk {lk} does not take the single-block form")
        o, lse = fa.flash_fwd_kernel(q, k, v, True)
        po, plse = fa.flash_attention_plain(q, k, v)
        err, rmax, fin = max_err(o, po)
        el, ml, fl = max_err(lse, plse)
        del o, lse, po, plse
        vt = v.movedim(1, 2).contiguous()
        t = timed_turns({"plain": lambda: fa.flash_attention_plain(q, k, v),
                         "kernel": lambda: fa.flash_fwd_kernel(q, k, v, True),
                         "library": lambda: sdpa_flash(q, k, vt)}, reps=5, calls=20)
        flop = 4 * b * n * lq * lk * d
        bnd = bound(2 * b * n * (lq + lk) * d * 2, bf16=flop)
        print(f"  K3 [2, 40, {lq:,} x {lk}, 128]: max_abs_err {err:.3e} (bound "
              f"{2.0 ** -6 * rmax:.3e}), lse {el:.3e} (bound {1e-5 * ml:.3e}); kernel "
              f"{t['kernel']:.4f} ms ({flop / (t['kernel'] * 1e9):.1f} TFLOP/s, "
              f"{bnd['bound_ms'] / t['kernel']:.3f} of the {bnd['bound_ms']:.4f} ms bound, "
              f"{bnd['bound_by']}), plain {t['plain']:.4f} ms, SDPA flash {t['library']:.4f} ms")
        expect(fin and err <= 2.0 ** -6 * rmax, f"K3 at lk {lk}: error {err}")
        expect(fl and el <= 1e-5 * ml, f"K3 at lk {lk}: lse error {el}")
        tag = f"image_lk{lk}"
        results["K3"].update({f"{tag}_ms": t["kernel"], f"{tag}_plain_ms": t["plain"],
                              f"{tag}_library_ms": t["library"],
                              f"{tag}_bound_ms": bnd["bound_ms"], f"{tag}_max_abs_err": err})
        del k, v, vt
    del q
    torch.cuda.empty_cache()

    # K10 at the i2v-14B int8 self-attention (--quant_attn int8, 21 frames,
    # CFG 2: 2 x 40 heads x 9,360), against its plain version at phase 2's
    # bounds (o two bf16 ulps of max|o|, lse 1e-5 max|lse|), timed in turns
    # with K1 on the same bf16 q/k/v
    b, lq = 2, 9360
    q, k, v = randn(b, n, lq, d), randn(b, n, lq, d), randn(b, lq, n, d)
    q8, sq = fa.quantize_bn(q)
    k8, sk = fa.quantize_bn(k)
    c = fa.qk8_scale(sq, sk, d)
    o, lse = fa.flash_qk8_kernel(q8, k8, v, c)
    po, plse = fa.flash_attention_qk8_plain(q8, k8, v, c)
    err, rmax, fin = max_err(o, po)
    el, ml, fl = max_err(lse, plse)
    del o, lse, po, plse
    t = timed_turns({"plain": lambda: fa.flash_attention_qk8_plain(q8, k8, v, c),
                     "kernel": lambda: fa.flash_qk8_kernel(q8, k8, v, c),
                     "K1": lambda: fa.flash_fwd_kernel(q, k, v, False)}, reps=3, calls=2)
    ops = 2 * b * n * lq * lq * d  # of each product
    bnd = bound(2 * b * n * lq * d + 2 * b * n * lq * d * 2 + b * n * 4, int8=ops, bf16=ops)
    print(f"  K10 [2, 40, {lq:,}, 128]: max_abs_err {err:.3e} (bound {2.0 ** -6 * rmax:.3e}), "
          f"lse {el:.3e} (bound {1e-5 * ml:.3e}); kernel {t['kernel']:.4f} ms "
          f"({2 * ops / (t['kernel'] * 1e9):.1f} TOPS, {bnd['bound_ms'] / t['kernel']:.3f} of "
          f"the {bnd['bound_ms']:.4f} ms bound), K1 {t['K1']:.4f} ms in the same turns, plain "
          f"{t['plain']:.4f} ms; {CARD}")
    expect(fin and err <= 2.0 ** -6 * rmax, f"K10 at 40 heads x {lq}: error {err}")
    expect(fl and el <= 1e-5 * ml, f"K10 at 40 heads x {lq}: lse error {el}")
    results["K10"].update({"h40_l9360_ms": t["kernel"], "h40_l9360_plain_ms": t["plain"],
                           "h40_l9360_k1_ms": t["K1"], "h40_l9360_bound_ms": bnd["bound_ms"],
                           "h40_l9360_max_abs_err": err})
    del q, k, v, q8, k8
    torch.cuda.empty_cache()

    # K4 at the i2v-1.3B training shape (batch 1, 12 heads, 21 frames:
    # 9,360 queries over the 257 CLIP keys), phase 5's bound: two bf16 ulps
    # of each gradient's largest entry
    lq, lk, n = 9360, 257, 12
    expect(fa.uses_merged_bwd(lq, lk), "K4: the image cross-attention takes the split route")
    q, k, v = randn(1, n, lq, d), randn(1, n, lk, d), randn(1, lk, n, d)
    o, lse = fa.flash_fwd_kernel(q, k, v, True)
    do = randn(*o.shape)
    got = fa.bwd_kernel(q, k, v, o, lse, do, True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    qs, ks = q.clone().requires_grad_(), k.clone().requires_grad_()
    vs = v.movedim(1, 2).contiguous().requires_grad_()
    out = sdpa_flash(qs, ks, vs)
    dot = do.movedim(1, 2).contiguous()
    t = timed_turns({"plain": lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do),
                     "kernel": lambda: fa.bwd_kernel(q, k, v, o, lse, do, True),
                     "library": lambda: torch.autograd.grad(out, (qs, ks, vs), dot,
                                                            retain_graph=True)},
                    reps=5, calls=20)
    flop = 10 * n * lq * lk * d
    bnd = bound(n * d * 2 * (3 * lq + 4 * lk) + 8 * n * lq, bf16=flop)
    part = {}
    report_many("K4", f"image cross-attention, 9,360 x {lk} keys", [
        (o_, a, b_, 2.0 ** -6) for o_, a, b_ in zip(("dq", "dk", "dv"), got, ref)],
        part, (t["kernel"], t["plain"]), library_ms=t["library"], **bnd)
    print(f"  K4 image cross-attention: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s, "
          f"{bnd['bound_ms'] / t['kernel']:.3f} of the bound, SDPA flash backward "
          f"{t['library']:.4f} ms")
    results["K4"].update({f"image_lk{lk}_{key}": val for key, val in part["K4"].items()})
    del q, k, v, o, lse, do, got, ref, qs, ks, vs, out, dot
    torch.cuda.empty_cache()

    # a block of i2v-14B, output and every gradient (the image branch's
    # included), card against CPU, at one latent frame of 832*480, as phase
    # 10 holds t2v-14B (one block: the CPU half is the slow part); then 2
    # blocks of flf2v-14B, output only
    cfg = wan_dit.i2v_14b(num_layers=1, remat_policy="attn")
    phase_grad_model(cfg, GRID_14B_1, seed=61, label="i2v-14B 1 block, 1,560 tokens: ")
    cfg = wan_dit.flf2v_14b(num_layers=2)
    state = from_jax_params(seeded_jax_tree(cfg, seed=63), cfg)
    rng = np.random.default_rng(64)
    shape = (1, GRID_14B_1[0], GRID_14B_1[1] * 2, GRID_14B_1[2] * 2)
    inputs = [torch.from_numpy(a) for a in (
        rng.standard_normal((*shape, 16), dtype=np.float32),
        rng.standard_normal((1, TEXT_LEN, cfg.text_dim), dtype=np.float32),
        rng.standard_normal((*shape, 20), dtype=np.float32),
        rng.standard_normal((2, 257, 1280), dtype=np.float32))]
    outs = {}
    for key in ("cuda", "cpu"):
        model = wan_dit.WanModel(cfg, device=torch.device(key))
        model.load_state_dict(state)
        x, ctx, y, clip = (a.to(key) for a in inputs)
        _build.reset_launches()
        with torch.inference_mode():
            outs[key] = model(x, torch.tensor([700.0], device=key), ctx, y=y, clip_fea=clip).cpu()
        if key == "cuda":
            launches = dict(_build.LAUNCHES)
        del model
    err, rmax, fin = max_err(outs["cuda"], outs["cpu"])
    want = dit_launches(2, False, self_single=True, i2v=True)
    print(f"  flf2v-14B 2 blocks, 1,560 tokens (514 image keys): max_abs_err {err:.3e} (bound "
          f"{3e-2 * rmax:.3e}, max|cpu| {rmax:.3e}); launches {launches}, derived {want}")
    expect(fin and rmax > 0 and err <= 3e-2 * rmax, f"flf2v-14B 2 blocks: error {err}")
    expect(launches == want, f"flf2v-14B launches {launches}, expected {want}")
    del state, outs, inputs
    torch.cuda.empty_cache()

    launches = _serve_i2v(dev)
    with tempfile.TemporaryDirectory(dir=root) as sub:
        launches = _add(launches, _train_i2v(sub, dev))
    return launches


def _serve_i2v(dev):
    """Phase 11's serving: i2v-14B and flf2v-14B at full width and depth
    through scripts/inference_torch.py, each pipeline freed before the next
    is built; returns the launches of every request."""
    import gc

    import torch

    cli = load_script("inference_torch")

    def build(task, flags=()):
        args = cli.args_init(["--task", task, "--size", SIZE, "--frame_num", "81",
                              "--sample_steps", "2", "--sample_guide_scale", "5.0",
                              "--device", "cuda", *flags])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = cli.build_pipeline(args)
        # a seeded non-zero head, as phase 4's (the JAX initialisers zero it)
        with torch.no_grad():
            pipe.model.head.head.weight.normal_(
                0.0, pipe.cfg.dim ** -0.5, generator=torch.Generator(device=dev).manual_seed(13))
        torch.cuda.synchronize()
        n_weights = sum(p.numel() for p in pipe.model.state_dict().values())
        print(f"  {task} pipeline {list(flags) or '(bf16)'} built in "
              f"{time.perf_counter() - t0:.2f} s: {n_weights / 1e9:.3f} B weights, "
              f"{pipe.cfg.num_layers} blocks, dim {pipe.cfg.dim}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {type(pipe).__name__}, "
              f"shift {args.sample_shift}")
        expect(pipe.cfg.num_layers == 40 and pipe.cfg.dim == 5120 and pipe.cfg.in_dim == 36,
               f"{task}: not the full-size model")
        return pipe, args

    def free(pipe):
        del pipe.model
        gc.collect()
        torch.cuda.empty_cache()

    def embeds(seed, *shape):
        return torch.randn(*shape, generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)

    def request(args, seed, text_seed, image_seed, frames, clip_frames=1):
        grid = cli.latent_grid(SIZE, frames)
        return cli.Request(
            seed=seed, context=embeds(text_seed, 1, TEXT_LEN, 4096),
            context_null=torch.zeros(1, TEXT_LEN, 4096, device=dev), frame_num=frames,
            sample_steps=2, sample_shift=args.sample_shift, guide_scale=args.sample_guide_scale,
            clip_fea=embeds(image_seed, clip_frames, 257, 1280),
            cond_latent=embeds(image_seed + 1, 1, *grid, 16))

    per_forward = dit_launches(40, False, i2v=True)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    pipe, args = build("i2v-14B")
    reqs = [request(args, 51, 201, 301, 81), request(args, 52, 202, 303, 21),
            request(args, 52, 202, 305, 21)]
    lats, launches = _serve(cli, pipe, reqs, per_forward, "i2v-14B bf16")
    # Two 21-frame requests with the same seed and text and another image
    # (cond_latent and CLIP features): y and the image branch reach the
    # latents only if they differ; the int8 bound below shows their scale
    apart = rel(lats[2], lats[1])
    print(f"  i2v-14B, seed 52, two images: latents {apart:.4f} apart (relative L2)")
    expect(apart > 1e-3, "another image gave the same latents: y or the image branch is lost")
    free(pipe)
    del pipe

    pipe, _ = build("i2v-14B", ("--quant", "int8", "--quant_attn", "int8"))
    lats8, launches8 = _serve(cli, pipe, [reqs[1]], dit_launches(40, False, qk8=True, i2v=True),
                              "i2v-14B int8")
    free(pipe)
    del pipe
    # phase 4's bound: the int8 sample within 0.3 relative L2 of the bf16
    # sample of the same request
    d = rel(lats8[0], lats[1])
    print(f"  i2v-14B int8 against bf16, seed 52, 21 frames: relative L2 distance {d:.4f} "
          f"(bound 0.3; the other image lies {apart:.4f} away)")
    expect(d <= 0.3, f"the int8 i2v latents lie {d} from the bf16 ones")

    pipe, args = build("flf2v-14B")
    defaults = cli.args_init(["--task", "flf2v-14B", "--size", SIZE])
    expect(args.sample_shift == defaults.sample_shift == 5.0 and defaults.sample_steps == 50,
           "flf2v-14B: the JAX CLI's defaults are 50 steps at shift 5.0")
    # 21 frames (81 until phase 14 came: the run's time limit); i2v's
    # 81-frame request above holds the 14B model at that length
    _, launches_f = _serve(cli, pipe, [request(args, 53, 203, 307, 21, clip_frames=2)],
                           per_forward, "flf2v-14B bf16")
    free(pipe)
    del pipe, lats, lats8
    return _add(_add(dict(launches), launches8), launches_f)


def _train_i2v(root, dev):
    """Phase 11's training: one i2v PRFL outer step through
    scripts/train_prfl_torch.py at i2v-1.3B, 21 frames; returns its
    launches."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    cli = load_script("train_prfl_torch")
    lists, null_dir = write_latent_cache(root, (21,), i2v=True)
    cfg_name, changes = PRFL_I2V
    trainer, config, build_s = _build_trainer(cli, published(cfg_name, {
        **changes, "dataset.meta_file_list": [lists[21]], "dataset.null_dir": null_dir,
        "save.output_dir": os.path.join(root, "out")}), dev)
    model = trainer.model
    cfg = model.dit_cfg
    n_lrm = model.lrm.dit_cfg.num_layers
    print(f"  i2v trainer built in {build_s:.2f} s: {config.task}, in_dim {cfg.in_dim}, policy "
          f"{sum(p.numel() for p in model.dit.parameters()) / 1e9:.3f} B fp32 master params; "
          f"is_i2v {model.cfg.is_i2v}")
    expect(model.cfg.is_i2v and not model.cfg.is_flf2v and cfg.model_type == "i2v",
           "the i2v task did not make an i2v trainer")
    watched = {name: p.detach().clone() for name, p in model.dit.named_parameters()
               if name in ("blocks.0.ffn_0.weight", "blocks.29.cross_attn.k_img.weight",
                           "blocks.3.cross_attn.v_img.weight", "blocks.7.cross_attn.norm_k_img",
                           "img_emb.fc1.weight", "img_emb.ln1_scale", "patch_embedding.weight")}
    expect(len(watched) == 7, f"watched weights missing: {sorted(watched)}")
    want = expected_train_launches(cfg.num_layers, n_lrm, int(config.train.fixed_mid),
                                   cfg.remat_policy, i2v=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    (m,) = cli.run(trainer, 1)
    torch.cuda.synchronize()
    got = dict(_build.LAUNCHES)
    print(f"  i2v-1.3B, 21 frames (9,360 tokens, 257 image keys): refl_loss "
          f"{m['refl_loss']:.6f}, reward {m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, "
          f"sft_loss {m['sft_loss']:.6f}, t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"i2v training: {key} is not finite: {m}")
    expect(m["grad_norm"] > 0, f"i2v training: grad norm {m['grad_norm']} is not above 0")
    params = dict(model.dit.named_parameters())
    for name, before in watched.items():
        moved = (params[name].detach() != before).float().mean().item()
        print(f"  {name}: {moved:.1%} of its entries moved")
        expect(moved > 0, f"i2v policy weight {name} did not move")
    print(f"  launches {got}, derived {want}")
    expect(got == want, f"i2v training launches {got}, expected {want}")
    del trainer, model
    torch.cuda.empty_cache()
    return got



# configs/train_pavrm_t2v_480.yaml as published, with no weights
PAVRM_T2V = ("train_pavrm_t2v_480.yaml", {"model.base_path": None})
# configs/train_pavrm_i2v_480.yaml with the loss and the lose list of
# configs/train_pavrm_bt_i2v_720.yaml (its 480p Bradley-Terry form)
PAVRM_BT_I2V = ("train_pavrm_i2v_480.yaml", {"model.base_path": None, "lrm.loss": "bt",
                                             "train_id": "pavrm_bt_i2v_480"})


def write_reward_cache(root, frames, n=2, i2v=False, seed=31):
    """A labelled latent cache in the reference's layout at 832*480: n clips
    of latents [1, 16, F, 60, 104], a short and a long caption each
    ([1, 20, 4096] and [1, 30, 4096]: every sample draws one), motion_quality
    good and poor in turn; with
    ``i2v`` the first-frame condition latent and CLIP features [1, 257,
    1280]; the null dir's uncond embedding. Returns (meta list, null dir)."""
    rng = np.random.default_rng(seed)
    null_dir = os.path.join(root, "null")
    os.makedirs(os.path.join(null_dir, "wanx"), exist_ok=True)
    for name in ("null", "uncond"):
        np.save(os.path.join(null_dir, "wanx", f"{name}.npy"),
                rng.standard_normal((1, 20, 4096), np.float32))
    lat_f = (frames - 1) // 4 + 1
    lines = []
    for i in range(n):
        stem = os.path.join(root, f"clip{frames}_{seed}_{i}")
        meta = {"vae_latent_path": stem + ".npy", "textshort_path": stem + "_short.npy",
                "short_caption": f"clip {i}", "textlong_path": stem + "_long.npy",
                "long_caption": f"the clip {i}", "motion_quality": ["good", "poor"][i % 2]}
        np.save(meta["vae_latent_path"],
                rng.standard_normal((1, 16, lat_f, 60, 104), np.float32))
        np.save(meta["textshort_path"], rng.standard_normal((1, 20, 4096), np.float32))
        np.save(meta["textlong_path"], rng.standard_normal((1, 30, 4096), np.float32))
        if i2v:
            meta.update(f1_black_path=stem + "_cond.npy", imgclip_path=stem + "_clip.npy")
            np.save(meta["f1_black_path"],
                    rng.standard_normal((1, 16, lat_f, 60, 104), np.float32))
            np.save(meta["imgclip_path"], rng.standard_normal((1, 257, 1280), np.float32))
        with open(stem + "_meta.json", "w") as f:
            json.dump(meta, f)
        lines.append(stem + "_meta.json")
    path = os.path.join(root, f"clips{frames}_{seed}.list")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path, null_dir


def _config(published_config, root, meta, null_dir, extra=None, **paths):
    """A published config (name, changes) on a cache under root: its meta
    list and null dir, the output under root/out, and ``paths``
    ({section__key: value}) and ``extra`` ({"section.key": value}) on top."""
    name, changes = published_config
    return published(name, {**changes, "dataset.meta_file_list": [meta],
                            "dataset.null_dir": null_dir,
                            "save.output_dir": os.path.join(root, "out"), **(extra or {}),
                            **{k.replace("__", "."): v for k, v in paths.items()}})


def _pavrm_run(cli, config, steps, label, want, dev="cuda"):
    """A PAVRM trainer of ``config`` through the CLI, ``steps`` steps with
    the counters set to 0 just before; checks its metrics, that the kept
    blocks and heads moved and the embeddings did not, and the launches
    against ``want``. Returns (trainer, history, launches, peak bytes)."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    t0 = time.perf_counter()
    trainer = cli.build_trainer(config, dev)
    torch.cuda.synchronize()
    params = dict(trainer.model.named_parameters())
    n_train = sum(p.numel() for p in trainer.state.params)
    print(f"  {label}: trainer built in {time.perf_counter() - t0:.2f} s, "
          f"{trainer.model.dit_cfg.num_layers} blocks of dim {trainer.model.dit_cfg.dim}; "
          f"{n_train / 1e9:.3f} B trainable fp32 params, "
          f"{sum(p.numel() for p in params.values()) / 1e9 - n_train / 1e9:.3f} B frozen")
    moved = [n for n in ("dit.blocks.0.ffn_0.weight", "dit.blocks.7.self_attn.q.weight",
                         "dit.blocks.3.cross_attn.k_img.weight", "q_attn.wq",
                         "mlp.Dense_2.weight") if n in params]
    frozen = [n for n in ("dit.text_0.weight", "dit.patch_embedding.weight",
                          "dit.img_emb.fc1.weight") if n in params]
    before = {n: params[n].detach().clone() for n in moved + frozen}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    hist = cli.run(trainer, steps)
    torch.cuda.synchronize()
    got = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for m in hist:
        print(f"  {label}, step {m['step']}: loss {m['loss']:.6f}, grad_norm "
              f"{m['grad_norm']:.6e}, acc {m['acc']:.2f}, step_time {m['step_time']:.3f} s")
        expect(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
               f"{label}: non-finite metrics {m}")
        expect(m["grad_norm"] > 0, f"{label}: grad norm {m['grad_norm']} is not above 0")
    for n in moved:
        frac = (params[n].detach() != before[n]).float().mean().item()
        print(f"  {label}: {n}: {frac:.1%} of its entries moved")
        expect(frac > 0, f"{label}: trainable {n} did not move")
    for n in frozen:
        expect(torch.equal(params[n], before[n]), f"{label}: frozen {n} moved")
    print(f"  {label}: launches over {steps} steps {got}, derived {want}")
    expect(got == want, f"{label}: launches {got}, expected {want}")
    return trainer, hist, got, peak


class _GradCapture:
    """An optimizer that keeps the step's gradients (on the CPU) and moves
    nothing."""

    def init(self, params, names=None):
        return {}

    def update(self, params, grads, opt_state, step):
        self.grads = [g.detach().float().cpu().clone() for g in grads]


def _pavrm_card_vs_cpu(seed=71, card="cuda", cfg=None):
    """12c: one PAVRM ce step of 1 t2v-14B block (cut from 2) with both
    heads at one latent frame (1,560 tokens), card against CPU: the loss at
    phase 3's bound and every gradient at phase 6's. Returns the card's
    launches."""
    import torch

    from hyvideo_prfl_torch.models import reward as rw
    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.schedulers import flow_match as fm
    from hyvideo_prfl_torch.training import common
    from hyvideo_prfl_torch.training.pavrm import PavrmConfig, PavrmModel, make_train_step
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    cfg = cfg or wan_dit.t2v_14b(num_layers=1, remat_policy="attn")
    pc = PavrmConfig(feature_layer=(cfg.num_layers,),
                     trainable_blocks=tuple(range(cfg.num_layers)), timesteps=(500,),
                     task="t2v-14b")
    q_attn = rw.QueryAttention(cfg.dim, pc.num_queries, pc.num_heads, pc.return_type)
    mlp = rw.RewardMLP(cfg.dim)
    q_attn.init_params(torch.Generator().manual_seed(seed))
    mlp.init_params(torch.Generator().manual_seed(seed + 1))
    state = {f"dit.{k}": v for k, v in from_jax_params(seeded_jax_tree(cfg, seed), cfg,
                                                          with_head=False).items()}
    state.update({f"q_attn.{k}": v for k, v in q_attn.state_dict().items()})
    state.update({f"mlp.{k}": v for k, v in mlp.state_dict().items()})
    rng = np.random.default_rng(seed + 2)
    f, hh, ww = GRID_14B_1[0], GRID_14B_1[1] * 2, GRID_14B_1[2] * 2
    batch = {"latents": rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32),
             "text": rng.standard_normal((1, TEXT_LEN, cfg.text_dim), dtype=np.float32),
             "labels": np.ones(1, np.float32)}
    noise = rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32)
    loss, probs, grads, launches, names = {}, {}, {}, {}, None
    for key, dev, cd in (("card", card, torch.bfloat16), ("cpu", "cpu", torch.bfloat16),
                         ("cpu fp32", "cpu", torch.float32)):
        model = PavrmModel(dataclasses.replace(cfg, compute_dtype=cd), pc,
                           device=torch.device(dev), param_dtype=torch.float32)
        model.load_state_dict(state)
        model.freeze_embeddings()
        tx = _GradCapture()
        st = common.init_train_state(model, tx)
        names = st.names
        step = make_train_step(model, tx, fm.train_schedule(1000))
        _build.reset_launches()
        t0 = time.perf_counter()
        st, m = step(st, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                     noise=torch.from_numpy(noise))
        if key == "card":
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        print(f"  12c: one PAVRM step, {key}: {time.perf_counter() - t0:.2f} s, loss "
              f"{float(m['loss']):.6f}, reward {float(m['probs'][0]):.6f}")
        loss[key], probs[key] = float(m["loss"]), float(m["probs"][0])
        grads[key] = dict(zip(names, tx.grads))
        del model, st, step
    # phase 3's bound on the output: 3e-2 of the CPU's
    err = abs(loss["card"] - loss["cpu"])
    print(f"  12c: loss card {loss['card']:.6f} against CPU {loss['cpu']:.6f} ({err:.3e}, "
          f"bound {3e-2 * abs(loss['cpu']):.3e}); reward {probs['card']:.6f} against "
          f"{probs['cpu']:.6f}")
    expect(math.isfinite(loss["card"]) and err <= 3e-2 * abs(loss["cpu"]),
           f"12c: the loss lies {err} from the CPU's")

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # Phase 6's bounds: 2e-2 of each gradient's norm against the CPU bf16
    # run; the attention k biases, whose gradients are near-cancelling sums
    # over keys, against the CPU fp32 run at 1.5x the CPU bf16 run's
    # distance from it. The pool's key bias shifts every logit of a head
    # alike, which the softmax ignores: its exact gradient is 0 and every
    # run returns rounding noise, held under 1e-3 of the pool's wk gradient.
    worst = []
    for name in names:
        got, ref = grads["card"][name], grads["cpu"][name]
        expect(bool(torch.isfinite(got).all()), f"12c: gradient of {name} is not finite")
        if name == "q_attn.bk":
            cap = 1e-3 * grads["cpu"]["q_attn.wk"].norm().item()
            print(f"  12c: {name}: norm {got.norm().item():.3e} on the card, "
                  f"{ref.norm().item():.3e} on the CPU (bound {cap:.3e}, analytically 0)")
            expect(got.norm().item() <= cap, f"12c: gradient of {name} is not near 0")
            continue
        expect(ref.norm().item() > 0, f"12c: gradient of {name} is zero on the CPU")
        if name.endswith(".k.bias"):
            exact = grads["cpu fp32"][name]
            noise_d, err = rel(ref, exact), rel(got, exact)
            print(f"  12c: {name}: card against CPU fp32 {err:.3e} (bound 1.5 x "
                  f"{noise_d:.3e})")
            expect(err <= 1.5 * noise_d, f"12c: gradient of {name}: {err} over 1.5 x {noise_d}")
            continue
        err = rel(got, ref)
        worst.append((err, name))
        expect(err <= 2e-2, f"12c: gradient of {name}: relative error {err:.3e} over 2e-2")
    worst.sort(reverse=True)
    print(f"  12c: the other {len(worst)} gradients within 2e-2 of the CPU bf16 run's, "
          f"relative to their norms; the largest: "
          + ", ".join(f"{n} {e:.3e}" for e, n in worst[:4]))
    want = expected_pavrm_launches(cfg.num_layers, "ce", self_single=fa.uses_single_block(1560))
    print(f"  12c: launches {launches}, derived {want}")
    expect(launches == want, f"12c: launches {launches}, expected {want}")
    torch.cuda.empty_cache()
    return launches


def _handoff(root, dev):
    """12d: PAVRM at t2v-1.3B width (the LRM: its first 8 blocks) trains 2
    steps and exports; the eval CLI scores the export, whose logits equal
    the trained tower's; the PRFL trainer (policy cut to 8 blocks) loads
    it and trains 2 outer steps with EMA and the optimizer state saved,
    then one more; a trainer resumed from checkpoint-2 takes that step
    again, to the bit, EMA included. Returns the launches."""
    import torch

    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.training import pavrm as tpavrm

    total = {}
    meta, null_dir = write_reward_cache(os.path.join(root, "cache"), 21, n=2)
    pav = load_script("train_pavrm_torch")
    pcfg = _config(PAVRM_T2V, root, meta, null_dir,
                   {"task": "t2v-1.3b", "train_id": "pavrm_t2v_1_3b"}, train__save_interval=2,
                   train__save_optimizer_state=True, dataset__val_meta_file_list=[meta])
    n_eval = len(pcfg.eval.timestep)  # one batch of both clips per eval timestep
    eval_fwd = _add({}, dit_launches(8, False, head=False), n_eval)
    want = _add(_add({}, expected_pavrm_launches(8, "ce"), 2), eval_fwd)
    # the val eval at step 2 adds its forwards to the steps'
    trainer, hist, got, _ = _pavrm_run(pav, pcfg, 2, "12d PAVRM t2v-1.3B, 21 frames", want,
                                       dev)
    _add(total, got)
    out = os.path.join(root, "out", "pavrm_t2v_1_3b")
    lrm = {"model__lrm_transformer_path": os.path.join(out, "transformer", "checkpoint-2"),
           "model__lrm_mlp_path": os.path.join(out, "mlp", "mlp_step_2.ckpt"),
           "model__lrm_query_attention_path": os.path.join(out, "mlp",
                                                           "query_attention_step_2.ckpt")}
    for path in lrm.values():
        expect(os.path.exists(path), f"12d: the export lacks {path}")
    for path in ("checkpoint-2", "checkpoint-2-opt"):
        expect(os.path.isdir(os.path.join(out, path)), f"12d: no {path}")

    # the eval CLI's own main on a --config_path: the phase writes the
    # config as YAML text, which the CLI reads with the port's reader
    infer = load_script("inference_pavrm_torch")
    icfg = _config(PAVRM_T2V, root, meta, null_dir, {"task": "t2v-1.3b"}, **lrm)
    ipath = os.path.join(root, "infer_pavrm_t2v_1_3b.yaml")
    with open(ipath, "w") as f:
        f.write(yaml_text(icfg) + "\n")
    _build.reset_launches()
    res = infer.main(["--config_path", ipath, "--device", str(dev)])
    torch.cuda.synchronize()
    got = dict(_build.LAUNCHES)
    print(f"  12d: inference_pavrm_torch main(['--config_path', {os.path.basename(ipath)!r}]) "
          f"launches {got}, derived {eval_fwd}")
    expect(got == eval_fwd, f"12d: eval launches {got}, expected {eval_fwd}")
    _add(total, got)
    mine = tpavrm.evaluate(trainer.eval_fn, trainer.val_dataset, icfg.eval.timestep,
                           int(icfg.eval.seed), dev)
    for key, val in res.items():
        expect(val["mean_reward"] == mine[key]["mean_reward"] and
               val["accuracy"] == mine[key]["accuracy"],
               f"12d: the export scores {val} at {key}, the trained model {mine[key]}")
    loaded = infer.load_lrm(icfg, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1, 6, 60, 104, 16, device=dev, generator=g)
    ctx = torch.randn(1, TEXT_LEN, 4096, device=dev, generator=g)
    t = torch.tensor([600.0], device=dev)
    with torch.no_grad():
        a, b = loaded.score(x, t, ctx), trainer.model.score(x, t, ctx)
    print(f"  12d: reloaded LRM logit {a.item():.6f} (bf16 storage), trained tower "
          f"{b.item():.6f} (fp32 masters; both cast to bf16 at use): "
          f"{'equal' if torch.equal(a, b) else 'DIFFERENT'}; eval mean rewards "
          + ", ".join(f"{k} {v['mean_reward']:.6f}" for k, v in res.items()))
    expect(torch.equal(a, b), f"12d: the reloaded LRM's logit {a.item()} is not the "
                              f"trained tower's {b.item()}")
    del trainer, loaded
    torch.cuda.empty_cache()

    # PRFL from the export. The merged backward's dq adds in run order, so
    # the step's bits repeat only on the split backward (K5), whose dq is
    # deterministic. Every sample draws its caption and its text drop, the
    # order is shuffled per epoch, and the resumed step (the third of two
    # clips) lies in the second epoch: the resumed loader replays the first.
    prfl = load_script("train_prfl_torch")
    cfg_name, changes = PRFL_T2V
    handoff = (cfg_name, {**changes, "train_id": "prfl_handoff", "dataset.shuffle": True,
                      "model.override": {"num_layers": 8}, "model.ema.use_ema": True})
    kw = dict(train__save_interval=2, train__save_optimizer_state=True, **lrm)
    per_step = expected_train_launches(8, 8, int(changes["train.fixed_mid"]), merged_bwd=False)
    fa.FLASH_MERGED_BWD = False
    try:
        whole = prfl.build_trainer(_config(handoff, root, meta, null_dir, **kw), dev)
        expect(torch.equal(whole.model.lrm.mlp.Dense_1.weight.float().cpu(),
                           torch.load(lrm["model__lrm_mlp_path"])["fc2.weight"]),
               "12d: the PRFL trainer did not load the exported head")
        _build.reset_launches()
        hist = prfl.run(whole, 2) + prfl.run(whole, 1)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        pout = os.path.join(root, "out", "prfl_handoff")
        ckpt = os.path.join(pout, "checkpoint-2")
        for path in (os.path.join(ckpt, "config.json"), os.path.join(ckpt, "opt_state"),
                     os.path.join(pout + "-ema", "checkpoint-2", "config.json")):
            expect(os.path.exists(path), f"12d: no {path}")
        resumed = prfl.build_trainer(_config(handoff, root, meta, null_dir,
                                             model__resume_transformer_path=ckpt, **kw), dev)
        _build.reset_launches()
        (m,) = prfl.run(resumed, 1)
        torch.cuda.synchronize()
        got_r = dict(_build.LAUNCHES)
    finally:
        fa.FLASH_MERGED_BWD = True
    for h in hist + [m]:
        print(f"  12d PRFL, step {h['step']}: refl_loss {h['refl_loss']:.6f}, reward "
              f"{h['reward']:.6f}, grad_norm {h['grad_norm']:.6e}, sft_loss "
              f"{h['sft_loss']:.6f}, t_refl {h['t_refl']:.3f} s, t_sft {h['t_sft']:.3f} s")
        expect(all(math.isfinite(h[k]) for k in ("refl_loss", "reward", "grad_norm",
                                                 "sft_loss")), f"12d: non-finite {h}")
    timing = ("t_refl", "t_sft")
    same = ({k: v for k, v in m.items() if k not in timing}
            == {k: v for k, v in hist[2].items() if k not in timing})
    bits = all(torch.equal(a, b) for a, b in zip(resumed.state.params, whole.state.params))
    ema = all(torch.equal(a, b) for a, b in zip(resumed.ema, whole.ema))
    print(f"  12d: the resumed step against the uninterrupted step 3: metrics "
          f"{'equal' if same else 'DIFFERENT'}, weights {'equal' if bits else 'DIFFERENT'}, "
          f"EMA {'equal' if ema else 'DIFFERENT'}")
    expect(same and bits and ema and resumed.state.step == whole.state.step,
           "12d: the resumed step is not the uninterrupted one")
    want = _add({}, per_step, 3)
    print(f"  12d: PRFL launches over 3 outer steps {got}, derived {want}; resumed {got_r}")
    expect(got == want and got_r == per_step, f"12d: PRFL launches {got} / {got_r}")
    _add(total, got)
    _add(total, got_r)
    del whole, resumed
    torch.cuda.empty_cache()
    return total


def _attn_kernels_at(results, name, tag, n, lq, lk, label, g, prefix, k5=True, reps=3):
    """The forward ``name`` (K1, or K3 where the keys fit one block) and
    K4 (and, with ``k5``, K5, bitwise on a second call) at [1, n, lq x lk,
    128] against their plain versions, timed beside their bound and SDPA's
    flash forward and backward; recorded under ``tag``."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    d = 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    # Bounds, as phases 2 and 5: o within two bf16 ulps of max|o|, lse 1e-5
    # max|lse|; dq, dk and dv each within two bf16 ulps of its largest entry
    q = randn(1, n, lq, d)
    single = fa.uses_single_block(lk)
    expect(single == (name == "K3"), f"{label}: lk {lk} takes the wrong forward")
    expect(fa.uses_merged_bwd(lq, lk), f"{label}: the backward takes the split route")
    k, v = randn(1, n, lk, d), randn(1, lk, n, d)
    vt = v.movedim(1, 2).contiguous()
    o, lse = fa.flash_fwd_kernel(q, k, v, single)
    po, plse = fa.flash_attention_plain(q, k, v)
    err, rmax, fin = max_err(o, po)
    el, ml, fl = max_err(lse, plse)
    del po, plse
    expect(fin and err <= 2.0 ** -6 * rmax, f"{name} at {n} heads x {lq} x {lk}: error {err}")
    expect(fl and el <= 1e-5 * ml, f"{name} at {n} heads x {lq} x {lk}: lse error {el}")
    calls = 1 if name == "K1" else 10
    t = timed_turns({"plain": lambda: fa.flash_attention_plain(q, k, v),
                     "kernel": lambda: fa.flash_fwd_kernel(q, k, v, single),
                     "library": lambda: sdpa_flash(q, k, vt)}, reps=reps, calls=calls)
    flop = 4 * n * lq * lk * d
    bnd = bound(2 * n * (lq + lk) * d * 2, bf16=flop)
    print(f"  {prefix} {name} [1, {n}, {lq:,} x {lk:,}, 128] ({label}): max_abs_err {err:.3e} "
          f"(bound {2.0 ** -6 * rmax:.3e}), lse {el:.3e} (bound {1e-5 * ml:.3e}); kernel "
          f"{t['kernel']:.4f} ms ({flop / (t['kernel'] * 1e9):.1f} TFLOP/s, "
          f"{bnd['bound_ms'] / t['kernel']:.3f} of the {bnd['bound_ms']:.4f} ms bound, "
          f"{bnd['bound_by']}), plain {t['plain']:.4f} ms, SDPA flash "
          f"{t['library']:.4f} ms; {CARD}")
    results[name].update({f"{tag}_ms": t["kernel"], f"{tag}_plain_ms": t["plain"],
                          f"{tag}_library_ms": t["library"],
                          f"{tag}_bound_ms": bnd["bound_ms"], f"{tag}_max_abs_err": err})

    # K4 on the same q, k, v, o and lse with a seeded cotangent
    do = randn(*o.shape)
    qs, ks = q.clone().requires_grad_(), k.clone().requires_grad_()
    vs = vt.clone().requires_grad_()
    out = sdpa_flash(qs, ks, vs)
    dot = do.movedim(1, 2).contiguous()
    t = timed_turns({"plain": lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do),
                     "kernel": lambda: fa.bwd_kernel(q, k, v, o, lse, do, True),
                     "library": lambda: torch.autograd.grad(out, (qs, ks, vs), dot,
                                                            retain_graph=True)},
                    reps=reps, calls=calls)
    del qs, ks, vs, out, dot
    got = fa.bwd_kernel(q, k, v, o, lse, do, True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    checks = [(o_, a, b, 2.0 ** -6) for o_, a, b in zip(("dq", "dk", "dv"), got, ref)]
    flop = 10 * n * lq * lk * d
    bnd = bound(n * d * 2 * (3 * lq + 4 * lk) + 8 * n * lq, bf16=flop)
    splits = fa.q_splits(n * -(-lk // 128), -(-lq // 64), sms)
    part = {}
    report_many("K4", f"{prefix} {label}, {n} heads x {lq:,} x {lk:,}", checks, part,
                (t["kernel"], t["plain"]), library_ms=t["library"], **bnd)
    print(f"  {prefix} K4 {label}: {flop / (t['kernel'] * 1e9):.1f} TFLOP/s, "
          f"{bnd['bound_ms'] / t['kernel']:.3f} of the bound, dk/dv q sweep split over "
          f"{splits} block(s) per key tile; {CARD}")
    results["K4"].update({f"{tag}_{key}": val for key, val in part["K4"].items()})
    del got
    if k5:
        # K5, the split backward (HYV_FLASH_MERGED_BWD=0 sends a 14B-wide
        # training step there: the route to a bitwise resume), on the same
        # tensors at phase 5's bounds, timed in turns with K4; its dq is
        # written once per q tile, so a second call gives the same bits
        got = fa.bwd_kernel(q, k, v, o, lse, do, False)
        again = fa.bwd_kernel(q, k, v, o, lse, do, False)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        t5 = timed_turns({"k4": lambda: fa.bwd_kernel(q, k, v, o, lse, do, True),
                          "kernel": lambda: fa.bwd_kernel(q, k, v, o, lse, do, False)},
                         reps=3, calls=calls)
        part = {}
        report_many("K5", f"{prefix} {label}, {n} heads x {lq:,} x {lk:,}",
                    [(o_, a, b, 2.0 ** -6) for o_, a, b in zip(("dq", "dk", "dv"), got, ref)],
                    part, (t5["kernel"], t["plain"]), library_ms=t["library"], k4_ms=t5["k4"],
                    **bnd)
        print(f"  {prefix} K5 {label}: {flop / (t5['kernel'] * 1e9):.1f} TFLOP/s, "
              f"{bnd['bound_ms'] / t5['kernel']:.3f} of the bound (K4 {t5['k4']:.4f} ms in "
              f"the same turns); dq, dk, dv bitwise equal on a second call: {same}; {CARD}")
        expect(same, f"{prefix} K5 {label}: not deterministic")
        results["K5"].update({f"{tag}_{key}": val for key, val in part["K5"].items()})
        del got
    del q, k, v, vt, o, lse, do, ref, checks
    torch.cuda.empty_cache()


def _pavrm_kernels(results):
    """12k: the kernels of the PAVRM step at the shapes 12a gives them
    (t2v-14B, batch 1, 32,760 tokens, 40 heads) against their plain
    versions, each timed beside its bound: K1 at the self-attention and K3
    at the text cross-attention (o and lse), K4 and K5 at both (dq, dk and
    dv; K5's bitwise equal on a second call), and K6-K9 at [1, 32,760,
    5120].
    Phases 2 and 5 hold these kernels at 12 heads and phase 10 K1 at 40
    heads x 18,900; the persistent grids take other tile counts here."""
    import torch

    g = torch.Generator(device=torch.device("cuda")).manual_seed(1357)
    lq = math.prod(GRID_81)
    for name, lk, label, tag in (("K1", lq, "self-attention", "pavrm_self"),
                                 ("K3", TEXT_LEN, "text cross-attention", "pavrm_text")):
        _attn_kernels_at(results, name, tag, 40, lq, lk, label, g, "12k")
    _norm_kernels_at(results, "pavrm_d5120", 40, GRID_81, g)


def phase_pavrm(results, root, dev="cuda"):
    """Phase 12: the PAVRM trainer at t2v-14B width (ce, the published
    config; the i2v-14B bt step is phase 16a's), card against CPU, and the LRM handoff
    to the PRFL trainer with checkpoint export, EMA and resume. Returns
    the launches."""
    import torch

    dev = torch.device(dev)
    cli = load_script("train_pavrm_torch")
    total = {}
    _pavrm_kernels(results)

    # 12a: configs/train_pavrm_t2v_480.yaml at t2v-14B width: the first 8
    # blocks, 81 frames at 832*480 (32,760 tokens), batch 1, remat "attn",
    # seeded weights, 3 steps over t 400, 500, 600 (the list cycled)
    meta, null_dir = write_reward_cache(os.path.join(root, "c81"), 81, n=2, seed=41)
    trainer, hist, got, peak = _pavrm_run(
        cli, _config(PAVRM_T2V, root, meta, null_dir), 3, "12a t2v-14B 81 frames",
        _add({}, expected_pavrm_launches(8, "ce"), 3), dev)
    warm = min(h["step_time"] for h in hist[1:])
    print(f"  12a: {CARD}: {warm:.3f} s/step (a warm step; the first "
          f"{hist[0]['step_time']:.3f}), peak {peak / 2**30:.2f} GiB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; t2v-14B width, 8 "
          f"blocks, 32,760 tokens, remat attn, no cut")
    expect(peak < torch.cuda.get_device_properties(0).total_memory, "12a: peak over the card")
    _add(total, got)
    del trainer
    torch.cuda.empty_cache()

    # 12b, the i2v-14B Bradley-Terry step, runs in phase 16a: at 21 frames
    # with and without the optimizer state offloaded, then at 81 frames,
    # which fit the card only with it offloaded

    _add(total, _pavrm_card_vs_cpu(card=dev))
    _add(total, _handoff(root, dev))
    return total


# The towers of phase 13, at the published widths: the Wan2.1 VAE, umT5-XXL
# and CLIP ViT-H/14 (the CPU rehearsal of the phase swaps them for tiny ones)
def vae13():
    from hyvideo_prfl_torch.models.vae import VAEConfig
    return VAEConfig()


def t5_13(**kw):
    from hyvideo_prfl_torch.models.t5 import umt5_xxl
    return umt5_xxl(**kw)


def clip13(**kw):
    from hyvideo_prfl_torch.models.clip import vit_h_14
    return vit_h_14(**kw)


class StubTokenizer:
    """The tokenizer wrapper's interface (utils/tokenizers.py) without
    tokenizer files: words -> ids by a fixed hash, an end token 1, zero
    padding to ``seq_len``."""

    def __init__(self, vocab_size, seq_len=TEXT_LEN):
        self.vocab_size, self.seq_len = vocab_size, seq_len

    def __call__(self, texts, return_mask=False):
        ids = np.zeros((len(texts), self.seq_len), np.int64)
        mask = np.zeros_like(ids)
        for i, text in enumerate(texts):
            toks = [2 + sum(map(ord, w)) * 7919 % (self.vocab_size - 2)
                    for w in text.split()][:self.seq_len - 1] + [1]
            ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
        return (ids, mask) if return_mask else (ids,)


def _timed(fn, dev):
    """(result, seconds, peak device bytes) of fn() on the card."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    return out, time.perf_counter() - t0, peak


def _frames_ok(label, frames, shape):
    """Finite frames of ``shape`` in [-1, 1]."""
    import torch

    expect(tuple(frames.shape) == tuple(shape), f"{label}: frames {tuple(frames.shape)}, "
           f"expected {tuple(shape)}")
    expect(bool(torch.isfinite(frames).all()), f"{label}: non-finite frames")
    lo, hi = frames.min().item(), frames.max().item()
    expect(-1.0 <= lo and hi <= 1.0, f"{label}: frames in [{lo}, {hi}], not [-1, 1]")
    return lo, hi


def _written_frames(label, path, shape):
    """The frames a CLI wrote for ``path``: its uint8 ``_frames.npy``, or
    the mp4 read back (by OpenCV, else imageio: whichever wrote it), each
    [T, H, W, 3] of ``shape``."""
    stem = os.path.splitext(path)[0]
    if os.path.exists(stem + "_frames.npy"):
        frames, kind = np.load(stem + "_frames.npy"), "uint8 frames .npy"
    else:
        expect(os.path.exists(path), f"{label}: neither {stem}_frames.npy nor {path} written")
        try:
            import cv2
        except ImportError:
            import imageio.v3 as iio

            frames, kind = iio.imread(path), "mp4, read back by imageio"
        else:
            cap, got = cv2.VideoCapture(path), []
            ok, f = cap.read()
            while ok:
                got.append(f)
                ok, f = cap.read()
            cap.release()
            frames, kind = np.stack(got) if got else np.zeros((0,)), "mp4, read back by OpenCV"
    expect(frames.dtype == np.uint8 and frames.shape == tuple(shape),
           f"{label}: frames {frames.dtype} {frames.shape}, expected uint8 {tuple(shape)}")
    print(f"  {label}: {kind} {frames.shape}")


def _free(dev):
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def seeded_vae_file(root):
    """The published VAE with seeded weights, on the CPU, and written as a
    reference file (``Wan2.1_VAE.pth``'s layout) under ``root``."""
    import torch

    from hyvideo_prfl_torch.models import vae as vae_mod
    from hyvideo_prfl_torch.utils import encoders

    cpu = vae_mod.init_params(vae_mod.WanVAE(vae13()), torch.Generator().manual_seed(81)).eval()
    path = encoders.save_reference({k: v.numpy() for k, v in cpu.state_dict().items()},
                                   os.path.join(root, "Wan2.1_VAE.pth"))
    return cpu, path


def _vae13(root, dev, numbers):
    """13a and 13b: the VAE card against CPU, then at 81 frames on the
    card; returns the card's VAE and its reference file."""
    import torch

    from hyvideo_prfl_torch.models import vae as vae_mod
    from hyvideo_prfl_torch.utils import encoders

    cpu, path = seeded_vae_file(root)
    vae = encoders.load_reference_vae(path, dev)  # as the CLIs load it
    n = sum(p.numel() for p in vae.parameters())
    print(f"  13a: VAE {vae.cfg}: {n / 1e6:.2f} M params, loaded from a seeded reference file")
    rng = np.random.default_rng(81)
    # Bound: fp32 against fp32, cuDNN's convolutions (TF32 off) against the
    # CPU's, a few ulps over ~30 layers: 1e-3 of max|CPU| (the CPU tests hold
    # the port to the JAX VAE at 1e-4)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 5, 64, 64, 3)).astype(np.float32))
    z_cpu = cpu.encode(x)
    checks = [("encode", vae.encode(x.to(dev)), z_cpu),
              ("encode_streaming", vae_mod.encode_streaming(vae, x.to(dev)), z_cpu)]
    x_cpu = cpu.decode(z_cpu)
    checks += [("decode", vae.decode(z_cpu.to(dev)), x_cpu),
               ("decode_streaming", vae_mod.decode_streaming(vae, z_cpu.to(dev), 1), x_cpu)]
    report_many("VAE", "5 x 64 x 64, card against CPU", [(a, b.cpu(), c, 1e-3)
                                                         for a, b, c in checks])
    # the same on the card alone at 9 frames: streaming against whole-clip
    x9 = torch.from_numpy(rng.uniform(-1, 1, (1, 9, 64, 64, 3)).astype(np.float32)).to(dev)
    z9 = vae.encode(x9)
    whole = vae.decode(z9).cpu()  # the stream returns its frames on the host
    report_many("VAE", "9 x 64 x 64 on the card, streaming against whole-clip", [
        ("encode", vae_mod.encode_streaming(vae, x9), z9, 1e-3),
        ("decode chunk 1", vae_mod.decode_streaming(vae, z9, 1), whole, 1e-3),
        ("decode chunk 2", vae_mod.decode_streaming(vae, z9, 2), whole, 1e-3)])
    del cpu

    # 13b: an 81-frame decode at 832*480, streaming one latent frame a step,
    # the frames moved to the host per chunk (the CLIs' decode), fp32 then bf16
    lat_f, lat_h, lat_w = load_script("inference_torch").latent_grid(SIZE, 81)
    t, s, _ = vae.cfg.stride
    shape = (1, (lat_f - 1) * t + 1, lat_h * s, lat_w * s, 3)
    g = torch.Generator(device=dev).manual_seed(82)
    z = torch.randn(1, lat_f, lat_h, lat_w, vae.cfg.z_dim, generator=g, device=dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        frames, dt, peak = _timed(lambda: vae_mod.decode_streaming(vae, z, 1, dtype=dtype), dev)
        lo, hi = _frames_ok(f"81-frame {name} decode", frames, shape)
        out[name] = frames
        numbers[f"decode81_{name}_s"], numbers[f"decode81_{name}_peak_gib"] = dt, peak / 2**30
        print(f"  13b: {CARD}: decode {tuple(z.shape)} -> {tuple(frames.shape)} streaming, "
              f"{name}: {dt:.3f} s, peak device memory {peak / 2**30:.2f} GiB; frames in "
              f"[{lo:.3f}, {hi:.3f}]")
    d = (out["bfloat16"] - out["float32"]).abs()
    print(f"  13b: bf16 against fp32 frames: max {d.max().item():.4f}, mean "
          f"{d.mean().item():.5f}")
    # Bound: the CPU tests' bf16 stream bound, 0.1 of the [-1, 1] frames
    expect(d.max().item() <= 0.1, f"81-frame bf16 decode: {d.max().item()} from fp32, over 0.1")
    # the decode is causal: the whole-clip decode of the first 3 latent
    # frames is the stream's first 9 frames. Bound: fp32 against fp32 in
    # another order of cuDNN's sums (1.1e-5 at 9 x 64 x 64 above): 1e-4 of
    # max|ref|
    n9 = 2 * t + 1
    head = vae.decode(z[:, :3]).cpu()
    report_many("VAE", f"81 x 480 x 832 stream, first {n9} frames against the whole-clip "
                "decode of 3 latent frames", [("decode", out["float32"][:, :n9], head, 1e-4)])
    del out, frames, d, head
    # the streaming encode of a 21-frame i2v conditioning video (a seeded
    # first frame, then zeros; phase 15's preprocess encodes 81 frames)
    f21 = 21
    vid = torch.zeros((1, f21, *shape[2:]), device=dev)
    vid[0, 0] = torch.rand(shape[2:], generator=g, device=dev) * 2 - 1
    lat, dt, peak = _timed(lambda: vae_mod.encode_streaming(vae, vid), dev)
    numbers["encode21_s"], numbers["encode21_peak_gib"] = dt, peak / 2**30
    expect(tuple(lat.shape) == (1, (f21 - 1) // t + 1, lat_h, lat_w, vae.cfg.z_dim)
           and bool(torch.isfinite(lat).all()), f"21-frame encode: latents {tuple(lat.shape)}")
    print(f"  13b: {CARD}: encode {tuple(vid.shape)} -> {tuple(lat.shape)} streaming, fp32: "
          f"{dt:.3f} s, peak device memory {peak / 2**30:.2f} GiB")
    # causal too: the whole-clip encode of the first 9 frames is the
    # stream's first 3 latent frames, at the same bound
    report_many("VAE", f"{f21} x 480 x 832 stream, first 3 latent frames against the "
                f"whole-clip encode of {n9} frames",
                [("encode", lat[:, :3], vae.encode(vid[:, :n9]), 1e-4)])
    del vid, lat
    _free(dev)
    return vae, path


def _t5_13(dev, numbers):
    """13c: umT5-XXL, 2 layers card against CPU, then the whole encoder on
    two prompts; returns their contexts [2, 512, dim] (prompt, negative)."""
    import copy

    import torch

    from hyvideo_prfl_torch.configs import SAMPLE_NEG_PROMPT
    from hyvideo_prfl_torch.models import t5 as t5_mod

    cli = load_script("inference_torch")
    cpu = t5_mod.init_params(t5_mod.T5Encoder(t5_13(num_layers=2)),
                             torch.Generator().manual_seed(83))
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(83)
    ids = torch.from_numpy(rng.integers(2, cpu.cfg.vocab_size, (2, 128)))
    mask = torch.ones(2, 128, dtype=torch.long)
    mask[1, 70:] = 0
    ids[1, 70:] = 0
    # Bound: both bf16 with fp32 norms and softmax, another summation order
    # in each product; the CPU tests hold the port to the JAX encoder at 3e-2
    # of max|JAX|: the same here
    report_many("umT5-XXL", "2 layers, 2 x 128 tokens (one padded from 70), card against CPU",
                [("output", card(ids.to(dev), mask.to(dev)).cpu(), cpu(ids, mask), 3e-2)])
    del cpu, card
    _free(dev)
    cfg = t5_13()
    t5, dt_init, _ = _timed(lambda: t5_mod.init_params(
        t5_mod.T5Encoder(cfg, device=dev), torch.Generator(device=dev).manual_seed(84)), dev)
    n = sum(p.numel() for p in t5.parameters())
    text = cli.TextEncoder(t5, StubTokenizer(cfg.vocab_size))
    prompts = ["a red fox runs through fresh snow at dawn, " * 8, SAMPLE_NEG_PROMPT]
    ctx, dt, peak = _timed(lambda: text(prompts), dev)
    lens = text.tokenizer(prompts, return_mask=True)[1].sum(1)
    numbers["t5_s"], numbers["t5_peak_gib"] = dt, peak / 2**30
    print(f"  13c: {CARD}: umT5-XXL ({cfg.num_layers} layers, dim {cfg.dim}, {n / 1e9:.3f} B "
          f"params in {cfg.compute_dtype}, built in {dt_init:.2f} s): two 512-token prompts "
          f"({list(map(int, lens))} tokens) in {dt:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB")
    expect(tuple(ctx.shape) == (2, TEXT_LEN, cfg.dim) and bool(torch.isfinite(ctx).all()),
           f"umT5 contexts {tuple(ctx.shape)}")
    for i, n_tok in enumerate(lens):
        expect(not ctx[i, n_tok:].any() and bool((ctx[i, :n_tok].abs().sum(-1) > 0).all()),
               f"umT5 context {i}: not its {n_tok} tokens, then zeros")
    del t5, text
    _free(dev)
    return ctx


def _clip13(dev, numbers):
    """13d: the CLIP ViT-H/14 tower, 2 blocks card against CPU, then the
    whole tower; returns it."""
    import copy

    import torch

    from hyvideo_prfl_torch.models import clip as clip_mod

    cpu = clip_mod.init_params(clip_mod.CLIPVisionTower(clip13(num_layers=2)),
                               torch.Generator().manual_seed(85))
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(85)
    frames = torch.from_numpy(rng.uniform(-1, 1, (2, 480, 832, 3)).astype(np.float32))
    images = clip_mod.preprocess_frames(frames, cpu.cfg.image_size)
    # Bound: fp32 (TF32 off) against fp32: 1e-3 of max|CPU|
    report_many("CLIP ViT-H/14", "2 blocks, two images, card against CPU", [
        ("preprocess", clip_mod.preprocess_frames(frames.to(dev), cpu.cfg.image_size).cpu(),
         images, 1e-3),
        ("use_31_block", card(images.to(dev)).cpu(), cpu(images), 1e-3),
        ("all blocks", card(images.to(dev), use_31_block=False).cpu(),
         cpu(images, use_31_block=False), 1e-3)])
    del cpu, card
    clip = clip_mod.init_params(clip_mod.CLIPVisionTower(clip13(), device=dev),
                                torch.Generator(device=dev).manual_seed(86))
    x = frames.to(dev)
    clip(clip_mod.preprocess_frames(x, clip.cfg.image_size))  # warm-up
    fea, dt, peak = _timed(lambda: clip(clip_mod.preprocess_frames(x, clip.cfg.image_size)), dev)
    n = sum(p.numel() for p in clip.parameters())
    numbers["clip_s"] = dt
    print(f"  13d: {CARD}: CLIP ViT-H/14 ({clip.cfg.num_layers} blocks, {n / 1e9:.3f} B fp32 "
          f"params): two 480 x 832 frames -> {tuple(fea.shape)} in {dt * 1e3:.2f} ms "
          f"(the resize included), peak device memory {peak / 2**30:.2f} GiB")
    expect(tuple(fea.shape) == (2, clip.cfg.num_patches + 1, clip.cfg.dim)
           and bool(torch.isfinite(fea).all()), f"CLIP features {tuple(fea.shape)}")
    return clip


def _serve13(root, dev, vae, vae_path, clip, ctx, numbers):
    """13e: t2v-1.3B through inference_torch.main with --vae_path, then one
    i2v-14B request from an image array; returns both runs' launches."""
    import torch

    from hyvideo_prfl_torch.models import vae as vae_mod
    from hyvideo_prfl_torch.ops import _build

    cli = load_script("inference_torch")
    save = os.path.join(root, "t2v13.mp4")
    _build.reset_launches()
    rc, dt, peak = _timed(lambda: cli.main(
        ["--task", "t2v-1.3B", "--size", SIZE, "--frame_num", "21", "--sample_steps", "2",
         "--vae_path", vae_path, "--save_file", save, "--device", dev.type]), dev)
    launches = dict(_build.LAUNCHES)
    grid = cli.latent_grid(SIZE, 21)
    t, s, _ = vae.cfg.stride
    shape = ((grid[0] - 1) * t + 1, grid[1] * s, grid[2] * s, 3)
    want = _add({}, dit_launches(30, False), 2)
    print(f"  13e: {CARD}: inference_torch.main t2v-1.3B, 21 frames, 2 steps, --vae_path: "
          f"rc {rc} in {dt:.3f} s (the pipeline's build and the VAE's load included), peak "
          f"device memory {peak / 2**30:.2f} GiB; launches {launches}, derived {want}")
    expect(rc == 0 and launches == want, f"t2v CLI: rc {rc}, launches {launches}")
    _written_frames("13e: the t2v CLI wrote", save, shape)
    numbers["t2v_cli_s"] = dt

    # one i2v-14B request from a seeded image array: CLIP and the VAE's
    # streaming encode (Conditioner.condition), the DiT, then the decode
    cond = cli.Conditioner(clip, vae)
    lat_f, lat_h, lat_w = cli.latent_grid(SIZE, 21)
    f_pix, h, w = cond.pixels(lat_f, lat_h, lat_w)
    g = torch.Generator(device=dev).manual_seed(87)
    image = torch.rand(1, h, w, 3, generator=g, device=dev) * 2 - 1
    (clip_fea, cond_latent), dt, peak = _timed(lambda: cond.condition(image, lat_f), dev)
    numbers["condition_s"] = dt
    print(f"  13e: condition() on a {h} x {w} image: CLIP {tuple(clip_fea.shape)}, latent "
          f"{tuple(cond_latent.shape)} from {f_pix} frames in {dt:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB")
    expect(tuple(cond_latent.shape) == (1, lat_f, lat_h, lat_w, 16)
           and bool(torch.isfinite(cond_latent).all()) and bool(torch.isfinite(clip_fea).all()),
           "i2v conditioning")
    del cond
    args = cli.args_init(["--task", "i2v-14B", "--size", SIZE, "--frame_num", "21",
                          "--sample_steps", "2", "--device", dev.type])
    pipe, dt_build, _ = _timed(lambda: cli.build_pipeline(args), dev)
    with torch.no_grad():  # a seeded non-zero head, as phase 11's
        pipe.model.head.head.weight.normal_(
            0.0, pipe.cfg.dim ** -0.5, generator=torch.Generator(device=dev).manual_seed(13))
    req = cli.Request(seed=54, context=ctx[:1], context_null=ctx[1:], frame_num=21,
                      sample_steps=2, sample_shift=args.sample_shift,
                      guide_scale=args.sample_guide_scale, clip_fea=clip_fea,
                      cond_latent=cond_latent)
    print(f"  13e: i2v-14B pipeline built in {dt_build:.2f} s ({pipe.cfg.num_layers} blocks, "
          f"dim {pipe.cfg.dim})")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (lat,), served = _serve(cli, pipe, [req], dit_launches(pipe.cfg.num_layers, False, i2v=True),
                            "13e i2v-14B from an image")
    video, dt, _ = _timed(lambda: vae_mod.decode(vae, lat), dev)  # the CLI's decode
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    lo, hi = _frames_ok("i2v decode", video, (1, f_pix, h, w, 3))
    numbers["i2v_decode_s"], numbers["i2v_peak_gib"] = dt, peak / 2**30
    print(f"  13e: {CARD}: i2v-14B latents {tuple(lat.shape)} decoded to {tuple(video.shape)} "
          f"in {dt:.3f} s (frames in [{lo:.3f}, {hi:.3f}]); peak device memory from the "
          f"request to its frames {peak / 2**30:.2f} GiB (the VAE and the CLIP tower resident, "
          f"umT5 freed)")
    del pipe, video, lat
    _free(dev)
    return _add(launches, served)


def _train13(root, dev, vae_path, numbers):
    """13f: one PRFL outer step of phase 7's run with the VAE's sanity decode."""
    from hyvideo_prfl_torch.ops import _build

    cli = load_script("train_prfl_torch")
    lists, null_dir = write_latent_cache(os.path.join(root, "cache13"), (21,))
    cfg_name, changes = PRFL_T2V
    config = published(cfg_name, {
        **changes, "dataset.meta_file_list": [lists[21]], "dataset.null_dir": null_dir,
        "save.output_dir": os.path.join(root, "out13"),
        "extra_model.vae.params_path": vae_path, "train.sanity_check_interval": 1})
    trainer, config, build_s = _build_trainer(cli, config, dev)
    expect(trainer.vae is not None, "the trainer did not load the VAE")
    cfg = trainer.model.dit_cfg
    want = expected_train_launches(cfg.num_layers, trainer.model.lrm.dit_cfg.num_layers,
                                   int(config.train.fixed_mid), cfg.remat_policy)
    _build.reset_launches()
    (m,), dt, peak = _timed(lambda: cli.run(trainer, 1), dev)
    got = dict(_build.LAUNCHES)
    numbers["train_sanity_s"] = dt
    print(f"  13f: {CARD}: one outer step with the sanity decode in {dt:.3f} s (t_refl "
          f"{m['t_refl']:.3f}, t_sft {m['t_sft']:.3f}; the rest is the decode of pred_x0 and "
          f"latent_next and their writes), peak device memory {peak / 2**30:.2f} GiB; "
          f"launches {got}, derived {want}")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"{key} is not finite: {m}")
    expect(got == want, f"13f launches {got}, expected {want}")
    sanity = os.path.join(trainer.out_dir, "sanity_check")
    grid = (6, 60, 104)  # write_latent_cache's 21-frame latents
    t, s, _ = trainer.vae.cfg.stride
    shape = ((grid[0] - 1) * t + 1, grid[1] * s, grid[2] * s, 3)
    for name in ("pred_x0", "latent_next"):
        _written_frames(f"13f: sanity {name}", os.path.join(sanity, f"step0_{name}.mp4"),
                        shape)
    del trainer
    _free(dev)
    return got


def phase_encoders(results, root, dev="cuda"):
    """Phase 13: the VAE, umT5-XXL and the CLIP tower, and the serving and
    training CLIs through them; returns the launches of 13e and 13f."""
    import torch

    dev = torch.device(dev)
    numbers = {}
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "cv2", "imageio", "transformers")}
    print(f"  13: this machine's image, video and tokenizer modules: {have}")
    vae, vae_path = _vae13(root, dev, numbers)
    ctx = _t5_13(dev, numbers)
    clip = _clip13(dev, numbers)
    launches = _serve13(root, dev, vae, vae_path, clip, ctx, numbers)
    del clip, ctx, vae
    _free(dev)
    launches = _add(launches, _train13(root, dev, vae_path, numbers))
    print(f"  phase 13 numbers ({CARD}): {json.dumps(numbers)}")
    return launches


# Phase 14: the rest of the serving CLI (the dpm++ and euler solvers,
# TeaCache, LoRA merging, --transformer_path, --prompt_file, t2i-14B)

# the TeaCache gate's threshold must sit at least this far (relative) from
# every sum it is compared with, so the card's and the CPU's gates, whose
# fp32 inputs differ in their last bits, take the same branch
GATE_MARGIN = 1e-3


def gate_inputs(model, steps, shift):
    """The TeaCache gate's inputs computed on the CPU: the fp32 time
    embedding e [1, dim] of each UniPC step's timestep, through a CPU copy
    of the model's time MLP."""
    import copy
    import types

    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.schedulers import unipc

    cpu = types.SimpleNamespace(cfg=model.cfg, time_0=copy.deepcopy(model.time_0).cpu().float(),
                                time_2=copy.deepcopy(model.time_2).cpu().float())
    with torch.no_grad():
        return [wan_dit.time_embed_only(cpu, torch.full((1,), float(t)))
                for t in unipc.unipc_schedule(steps, shift=shift).timesteps]


def pick_teacache_threshold(es, coeffs):
    """A threshold for the gate over the inputs ``es`` that skips at least
    one interior step, as far (relative) from every sum the gate compares
    with it as the candidates allow: midpoints between the sums of runs of
    consecutive steps' rescaled changes, preferring a pattern that also
    computes an interior step. -> (threshold, skip pattern, margin). The
    pattern is checked against ``teacache.should_skip`` itself."""
    import torch

    from hyvideo_prfl_torch.ops import teacache as tc

    n = len(es)
    polys = [None] + [tc._poly(coeffs, (es[i] - es[i - 1]).abs().mean()
                               / es[i - 1].abs().mean().clamp_min(1e-8)) for i in range(1, n)]

    def simulate(thresh):
        # the gate's arithmetic: fp32 sums from 0 after each computed step
        accum, pattern, compared = torch.zeros(()), [False], []
        for i in range(1, n - 1):
            accum = accum + polys[i]
            compared.append(float(accum))
            pattern.append(bool(accum < thresh))
            if not pattern[-1]:
                accum = torch.zeros(())
        pattern.append(False)
        margin = min(abs(c - thresh) for c in compared) / max(abs(thresh), 1e-6)
        return pattern, margin

    sums = set()
    for j in range(1, n - 1):
        accum = torch.zeros(())
        for i in range(j, n - 1):
            accum = accum + polys[i]
            sums.add(float(accum))
    sums = sorted(sums)
    candidates = [(a + b) / 2 for a, b in zip(sums, sums[1:])] + [sums[-1] + abs(sums[-1]) + 1]
    best = None
    for thresh in candidates:
        pattern, margin = simulate(thresh)
        interior = pattern[1:-1]
        if not any(interior):
            continue
        key = (not all(interior), margin)
        if best is None or key > best[0]:
            best = (key, thresh, pattern, margin)
    expect(best is not None, "no TeaCache threshold skips a step")
    _, thresh, pattern, margin = best
    state, got = tc.init_state(), []
    for i, e in enumerate(es):
        skip, state = tc.should_skip(state, e, i, n, thresh, coeffs)
        got.append(skip)
    expect(got == pattern, f"the gate's skips {got} are not the simulated {pattern}")
    return thresh, pattern, margin


def teacache_launches(n_layers, pattern, **kw):
    """Kernel launches of a TeaCache chain: a full DiT forward on each
    computed step; a skipped one runs only the head (one K8)."""
    skipped = sum(pattern)
    return _add({"K8": skipped} if skipped else {},
                dit_launches(n_layers, False, **kw), len(pattern) - skipped)


def seeded_lora(cfg, rank, seed, dev, std=0.01):
    """A LoRA tree of q/k/v/o of the self- and cross-attention of every
    block (the port's layout), A and B seeded normal(0, std) on ``dev``."""
    import torch

    from hyvideo_prfl_torch.training import lora as lora_mod

    g = torch.Generator(device=dev).manual_seed(seed)
    n, d = cfg.num_layers, cfg.dim
    return {"lora": {attn: {m: {"A": torch.randn(n, d, rank, generator=g, device=dev) * std,
                                "B": torch.randn(n, rank, d, generator=g, device=dev) * std}
                            for m in lora_mod.DEFAULT_TARGETS}
                     for attn in ("self_attn", "cross_attn")}}


def write_loras(cfg, root, dev, rank, seed):
    """Two seeded LoRAs written as the CLI reads them: a kohya-format
    .safetensors (for --lora_path) and a transformer-format .pt (for
    --distill_lora_path), bf16, in the reference layout."""
    import torch

    from hyvideo_prfl_torch.training import lora as lora_mod
    from hyvideo_prfl_torch.utils import safetensors_io

    paths = []
    for i, (fmt, name) in enumerate((("kohya", "style.safetensors"),
                                     ("transformer", "distill.pt"))):
        tree = seeded_lora(cfg, rank, seed + i, dev)
        sd = {k: v.to("cpu", torch.bfloat16)
              for k, v in lora_mod.lora_state_dict(tree, fmt, cfg.head_dim).items()}
        path = os.path.join(root, name)
        if name.endswith(".pt"):
            torch.save(sd, path)
        else:
            safetensors_io.write_file(sd, path)
        paths.append(path)
        del tree, sd
    return paths


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _solvers_card_vs_cpu(cli, dev, numbers):
    """14a: 2 blocks of t2v-1.3B at full width, one latent frame of 832*480:
    dpm++ (3 steps), euler (2) and TeaCache (8 UniPC steps), card against
    CPU, the skip patterns equal; then two LoRAs merged on the card against
    the same merged in the reference layout and loaded."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import teacache as tc
    from hyvideo_prfl_torch.pipelines import pipeline as pl
    from hyvideo_prfl_torch.training import lora as lora_mod
    from hyvideo_prfl_torch.utils import checkpoint as ck

    cfg = dataclasses.replace(cli.dit_config_for_task("t2v-1.3B"), num_layers=2)
    state = ck.from_jax_params(ck.seeded_jax_tree(cfg, seed=91), cfg)
    grid = cli.latent_grid(SIZE, 1)
    tokens = math.prod(grid) // 4
    rng = np.random.default_rng(92)
    ctx = torch.from_numpy(rng.standard_normal((1, cfg.text_len, cfg.text_dim), dtype=np.float32))
    null = ctx * 0.1
    noise = torch.from_numpy(rng.standard_normal((1, *grid, cfg.out_dim), dtype=np.float32))
    pipes = {}
    for d in ("cpu", dev.type):
        model = wan_dit.WanModel(cfg, device=torch.device(d))
        model.load_state_dict(state)
        pipes[d] = pl.WanT2V(model.eval())
    single = fa.uses_single_block(tokens)
    per_forward = dit_launches(cfg.num_layers, False, self_single=single)
    es = gate_inputs(pipes["cpu"].model, 8, 5.0)
    coeffs = "t2v-1.3b"
    thresh, pattern, margin = pick_teacache_threshold(es, tc.COEFFICIENTS[coeffs])
    print(f"  14a: the CPU gate over 8 steps ({coeffs}): threshold {thresh:.6g}, skips "
          f"{[i for i, s in enumerate(pattern) if s]}, every compared sum at least "
          f"{margin:.3g} (relative) from it (needed {GATE_MARGIN})")
    expect(margin >= GATE_MARGIN, f"the gate's threshold lies {margin} from a sum")
    # dpm++ at 3 steps still takes its second-order update (the middle step)
    runs = (("dpm++", 3, None), ("euler", 2, None), ("teacache", 8, thresh))
    for solver, steps, th in runs:
        out, skips = {}, {}
        for d, pipe in pipes.items():
            gen = pl.GenerateConfig(sampling_steps=steps, shift=5.0, guide_scale=5.0,
                                    sample_solver="unipc" if th is not None else solver)
            c, c0 = ctx.to(d), null.to(d)
            _build.reset_launches()
            if th is None:
                lat, dt, _ = _timed(lambda: pipe.generate(None, c, c0, *grid, gen,
                                                          noise=noise), torch.device(d))
            else:
                lat, dt, _ = _timed(lambda: pipe.sample_teacache(
                    None, (1, *grid, cfg.out_dim), c, c0, gen, thresh=th, coeffs_key=coeffs,
                    noise=noise), torch.device(d))
                skips[d] = list(pipe.teacache_skips)
            out[d] = lat.cpu()
            launches = dict(_build.LAUNCHES)
            print(f"  14a {solver} {steps} steps on {d}: {dt:.3f} s")
        want = (_add({}, per_forward, steps) if th is None
                else teacache_launches(cfg.num_layers, pattern, self_single=single))
        expect(launches == want, f"14a {solver}: launches {launches}, expected {want}")
        d = _rel(out[dev.type], out["cpu"])
        moved = _rel(out["cpu"], noise)
        # Bound: both sides bf16, rounding in another order (phase 3 holds one
        # forward of these blocks within 3e-2 of max|CPU|), through 2-8 CFG
        # steps; on the CPU the same chains in bf16 lie 0.0035-0.0038
        # (relative L2) from fp32 ones, and the chain moves the noise by
        # ~1.7: bound 0.02, about five times the bf16 noise
        print(f"  14a {solver}: card against CPU, relative L2 {d:.5f} (bound 0.02; the chain "
              f"moved the noise by {moved:.3f}); launches {launches}")
        expect(all(bool(torch.isfinite(o).all()) for o in out.values()),
               f"14a {solver}: non-finite latents")
        expect(moved > 0.5 and d <= 0.02, f"14a {solver}: card against CPU {d} (moved {moved})")
        if th is not None:
            print(f"  14a TeaCache skips: card {skips[dev.type]}, CPU {skips['cpu']}, "
                  f"the CPU gate alone {pattern}")
            expect(skips[dev.type] == skips["cpu"] == pattern, "14a: TeaCache skip patterns "
                   f"differ: card {skips[dev.type]}, CPU {skips['cpu']}, gate {pattern}")
            numbers["14a_teacache_skipped"] = sum(pattern)
        numbers[f"14a_{solver}_rel_l2"] = d

    # two LoRAs merged on the card in place, against the same merged into
    # the reference state (on the card) and loaded through from_reference_state
    card = pipes[dev.type].model
    base = {k: v.clone() for k, v in card.state_dict().items()}
    trees = [seeded_lora(cfg, 128, s, dev, std=0.02) for s in (93, 94)]
    sds = [lora_mod.lora_state_dict(t, fmt, cfg.head_dim)
           for t, fmt in zip(trees, ("kohya", "transformer"))]
    scales = (1.0, 0.5)
    # the reference state in fp32 (exact for every port tensor), the LoRA's
    # targets in their storage dtype on the card, where the merge computes
    ref = ck.to_reference_state(base, cfg)
    for k in base:
        if k.startswith("blocks.") and k.endswith(".weight") \
                and k.split(".")[-2] in lora_mod.DEFAULT_TARGETS:
            ref[k] = ref[k].to(dev, base[k].dtype)
    for sd, scale in zip(sds, scales):
        lora_mod.merge_lora_state(ref, lora_mod.lora_from_state_dict(sd), scale)
    want = wan_dit.WanModel(cfg, device=dev)
    want.load_state_dict(ck.from_reference_state({k: v.cpu() for k, v in ref.items()}, cfg))
    for sd, scale in zip(sds, scales):
        lora_mod.merge_lora(card, lora_mod.lora_from_state_dict(sd, head_dim=cfg.head_dim), scale)
    want = want.state_dict()
    moved = [k for k, v in card.state_dict().items() if not torch.equal(v, base[k])]
    same = all(torch.equal(v, want[k]) for k, v in card.state_dict().items())
    print(f"  14a: two rank-128 LoRAs (kohya, transformer) merged on the card into "
          f"{len(moved)} weights: equal bit for bit to the merge in the reference layout "
          f"loaded through from_reference_state: {same}")
    expect(same and len(moved) == cfg.num_layers * 8, f"14a LoRA: equal {same}, moved "
           f"{len(moved)}")
    del pipes, card, want, ref, base


def _solvers81(cli, dev, numbers):
    """14b: t2v-1.3B at full depth, 81 frames, through the CLI's pipeline:
    UniPC, dpm++ and euler, 3 steps each, launches as derived; returns them."""
    import torch

    args = cli.args_init(["--task", "t2v-1.3B", "--size", SIZE, "--frame_num", "81",
                          "--sample_steps", "3", "--device", dev.type])
    pipe = cli.build_pipeline(args)
    cfg = pipe.cfg
    g = torch.Generator(device=dev).manual_seed(95)
    with torch.no_grad():  # a seeded non-zero head, as phase 4's
        pipe.model.head.head.weight.normal_(0.0, cfg.dim ** -0.5, generator=g)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev)
    null = torch.zeros_like(ctx)
    total, lats = {}, {}
    for solver in ("unipc", "dpm++", "euler"):
        req = cli.Request(seed=46, context=ctx, context_null=null, frame_num=81,
                          sample_steps=3, guide_scale=5.0, sample_solver=solver)
        (lat,), launches = _serve(cli, pipe, [req], dit_launches(cfg.num_layers, False),
                                  f"14b {solver}")
        _, dt, _ = _timed(lambda: cli.run_request(pipe, req, SIZE), dev)
        numbers[f"14b_{solver}_s_per_step"] = dt / req.sample_steps
        print(f"  14b: {CARD}: {solver} at 81 frames, again: {dt / req.sample_steps:.4f} s/step")
        lats[solver] = lat
        _add(total, launches)
    for solver in ("dpm++", "euler"):
        d = _rel(lats[solver], lats["unipc"])
        print(f"  14b: {solver} against UniPC, seed 46: relative L2 {d:.4f}")
        expect(d > 1e-3, f"14b: {solver} gave UniPC's latents")
    del pipe, lats
    _free(dev)
    return total


def _t2i14(cli, root, dev, numbers):
    """14c: t2i-14B at full width and depth with two LoRAs and TeaCache, to
    a PNG; returns the launches."""
    import torch

    from hyvideo_prfl_torch.models import vae as vae_mod
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import teacache as tc
    from hyvideo_prfl_torch.training import lora as lora_mod
    from hyvideo_prfl_torch.utils import checkpoint as ck

    cfg = cli.dit_config_for_task("t2i-14B")
    (lora_a, lora_b), dt, _ = _timed(lambda: write_loras(cfg, root, dev, 128, 96), dev)
    print(f"  14c: two seeded rank-128 LoRAs written in {dt:.2f} s "
          f"({os.path.getsize(lora_a) / 1e9:.2f} GB kohya .safetensors, "
          f"{os.path.getsize(lora_b) / 1e9:.2f} GB transformer .pt)")
    args = cli.args_init(["--task", "t2i-14B", "--size", SIZE, "--sample_steps", "10",
                          "--device", dev.type, "--lora_path", lora_a, "--lora_scale", "0.8",
                          "--distill_lora_path", lora_b, "--distill_lora_alpha", "1.0",
                          "--teacache_thresh", "0.1", "--save_file",
                          os.path.join(root, "t2i.mp4")])
    expect(args.frame_num == 1, f"t2i-14B: frame_num {args.frame_num}")
    # keep the attention weights as loaded, before the CLI merges the LoRAs
    keys = [f"blocks.{i}.{a}.{m}.weight" for i in range(cfg.num_layers)
            for a in ("self_attn", "cross_attn") for m in lora_mod.DEFAULT_TARGETS]
    snap, load_dit = {}, cli.load_dit

    def keep(*a):
        model = load_dit(*a)
        params = dict(model.named_parameters())
        snap.update({k: params[k].detach().clone() for k in keys})
        return model

    cli.load_dit = keep
    try:
        pipe, dt_build, _ = _timed(lambda: cli.build_pipeline(args), dev)
    finally:
        cli.load_dit = load_dit
    print(f"  14c: t2i-14B pipeline ({cfg.num_layers} blocks, dim {cfg.dim}) built with both "
          f"LoRAs merged in {dt_build:.2f} s")
    # the same LoRAs merged in the reference layout: each weight's rows back
    # to the reference order (from_reference_state's permutation, inverted),
    # the merge, then the rows to the port's order as from_reference_state
    # puts them; bit for bit the CLI's merge, since permuting rows and adding
    # elementwise commute
    perm = torch.from_numpy(ck.rope_perm_full(cfg.dim, cfg.head_dim)).to(dev)
    inv = torch.argsort(perm)
    moved = {k: k.split(".")[2] == "self_attn" and k.split(".")[3] in ("q", "k") for k in keys}
    for k in keys:
        if moved[k]:
            snap[k] = snap[k][inv]
    for path, scale in ((lora_a, args.lora_scale), (lora_b, args.distill_lora_alpha)):
        lora_mod.merge_lora_state(snap, lora_mod.lora_from_state_dict(cli.read_state_dict(path)),
                                  scale)
    params = dict(pipe.model.named_parameters())
    same = all(torch.equal(params[k], snap[k][perm] if moved[k] else snap[k]) for k in keys)
    print(f"  14c: the CLI's merge of {len(keys)} weights against the reference layout's: "
          f"equal bit for bit: {same}")
    expect(same, "14c: the merged weights differ from the reference layout's merge")
    del snap, params
    _free(dev)
    with torch.no_grad():  # a seeded non-zero head, as phase 4's (no LoRA targets it)
        pipe.model.head.head.weight.normal_(
            0.0, cfg.dim ** -0.5, generator=torch.Generator(device=dev).manual_seed(97))
    es = gate_inputs(pipe.model, args.sample_steps, args.sample_shift)
    key = cli.teacache_key(args.task)
    thresh, pattern, margin = pick_teacache_threshold(es, tc.COEFFICIENTS[key])
    print(f"  14c: the CPU gate over {args.sample_steps} steps ({key}): threshold {thresh:.6g}, "
          f"skips {[i for i, s in enumerate(pattern) if s]}, margin {margin:.3g}")
    expect(margin >= GATE_MARGIN, f"14c: the gate's threshold lies {margin} from a sum")
    g = torch.Generator(device=dev).manual_seed(98)
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=g, device=dev)
    req = cli.Request(seed=args.base_seed, context=ctx, context_null=torch.zeros_like(ctx),
                      frame_num=args.frame_num, sample_steps=args.sample_steps,
                      sample_shift=args.sample_shift, guide_scale=args.sample_guide_scale,
                      teacache_thresh=thresh, teacache_key=key)
    _build.reset_launches()
    lat, dt, peak = _timed(lambda: cli.run_request(pipe, req, SIZE), dev)
    launches = dict(_build.LAUNCHES)
    skips = list(pipe.teacache_skips)
    tokens = math.prod(cli.latent_grid(SIZE, 1)) // 4
    want = teacache_launches(cfg.num_layers, pattern, self_single=fa.uses_single_block(tokens))
    n_comp = len(skips) - sum(skips)
    numbers.update({"14c_s": dt, "14c_peak_gib": peak / 2**30, "14c_computed": n_comp,
                    "14c_skipped": sum(skips)})
    print(f"  14c: {CARD}: t2i-14B, {tokens:,} tokens, TeaCache over {len(skips)} UniPC steps: "
          f"computed {n_comp}, skipped {[i for i, s in enumerate(skips) if s]}, {dt:.3f} s "
          f"({dt / len(skips):.4f} s/step), peak device memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}, derived {want}")
    expect(skips == pattern, f"14c: the card skipped {skips}, the CPU gate {pattern}")
    expect(launches == want, f"14c: launches {launches}, expected {want}")
    expect(tuple(lat.shape) == (1, *cli.latent_grid(SIZE, 1), 16)
           and bool(torch.isfinite(lat).all()), f"14c latents {tuple(lat.shape)}")
    del pipe
    _free(dev)
    vae = vae_mod.init_params(vae_mod.WanVAE(vae13(), device=dev),
                              torch.Generator(device=dev).manual_seed(99)).eval()
    video, dt, _ = _timed(lambda: vae_mod.decode(vae, lat, args.decode_chunk), dev)
    written = cli.write_frames(video[0], args.save_file)
    t, s, _ = vae.cfg.stride
    shape = (lat.shape[2] * s, lat.shape[3] * s, 3)
    expect(written.endswith(".png") and os.path.exists(written), f"14c: wrote {written}")
    try:
        from PIL import Image
        img = np.asarray(Image.open(written))
    except ImportError:
        import cv2
        img = cv2.imread(written)
    print(f"  14c: decoded in {dt:.3f} s and written: {os.path.basename(written)} {img.shape} "
          f"{img.dtype}")
    expect(img.shape == shape and img.dtype == np.uint8, f"14c: image {img.shape}")
    del vae, video
    _free(dev)
    return launches


def _records14(cli, root, dev, numbers):
    """14d: two txt records through inference_torch.main with
    --transformer_path, a seeded umT5 and --save_folder; the first record
    against a single --prompt run of its seed; returns the launches."""
    import torch

    from hyvideo_prfl_torch.models import t5 as t5_mod
    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.utils import checkpoint as ck

    cfg = cli.dit_config_for_task("t2v-1.3B")
    model = wan_dit.init_params(wan_dit.WanModel(cfg, device=dev),
                                torch.Generator(device=dev).manual_seed(100))
    with torch.no_grad():
        model.head.head.weight.normal_(0.0, cfg.dim ** -0.5,
                                       generator=torch.Generator(device=dev).manual_seed(101))
    export, dt, _ = _timed(lambda: ck.save_reference_dir(model.state_dict(), cfg,
                                                         os.path.join(root, "prfl"), step=7), dev)
    print(f"  14d: a post-trained transformer exported by save_reference_dir in {dt:.2f} s: "
          f"{sorted(os.listdir(export))}")
    del model
    _free(dev)
    t5cfg = t5_13()
    t5 = t5_mod.init_params(t5_mod.T5Encoder(t5cfg, device=dev),
                            torch.Generator(device=dev).manual_seed(102))
    text = cli.TextEncoder(t5, StubTokenizer(t5cfg.vocab_size))
    prompts = ["a red fox runs through fresh snow at dawn",
               "a paper boat drifts down a rainy street"]
    with open(os.path.join(root, "prompts.txt"), "w") as f:
        f.write("\n".join(prompts) + "\n")
    common = ["--task", "t2v-1.3B", "--size", SIZE, "--frame_num", "21", "--sample_steps", "2",
              "--transformer_path", export, "--t5_path", "seeded-umt5", "--tokenizer", "stub",
              "--base_seed", "60", "--save_file", "gen.mp4", "--device", dev.type]
    make_text_encoder = cli.make_text_encoder
    cli.make_text_encoder = lambda args, device: text
    try:
        _build.reset_launches()
        rc, dt, peak = _timed(lambda: cli.main(
            [*common, "--prompt_file", os.path.join(root, "prompts.txt"),
             "--save_folder", os.path.join(root, "records")]), dev)
        launches = dict(_build.LAUNCHES)
        rc1, dt1, _ = _timed(lambda: cli.main(
            [*common, "--prompt", prompts[0], "--save_folder", os.path.join(root, "one")]), dev)
        launches1 = dict(_build.LAUNCHES)
    finally:
        cli.make_text_encoder = make_text_encoder
    per_run = _add({}, dit_launches(cfg.num_layers, False), 2)
    want = _add({}, per_run, 2)
    numbers.update({"14d_records_s": dt, "14d_single_s": dt1})
    files = sorted(os.listdir(os.path.join(root, "records")))
    print(f"  14d: {CARD}: main over 2 records: rc {rc} in {dt:.3f} s (the transformer's load, "
          f"the texts, 2 x 2 steps at 21 frames), peak device memory {peak / 2**30:.2f} GiB; "
          f"wrote {files}; launches {launches}, derived {want}; the single --prompt run: rc "
          f"{rc1} in {dt1:.3f} s")
    expect(rc == 0 and rc1 == 0, f"14d: rc {rc}, {rc1}")
    expect(files == ["gen_000_latents.npy", "gen_001_latents.npy"], f"14d: wrote {files}")
    expect(launches == want, f"14d: launches {launches}, expected {want}")
    got1 = _add({}, launches1)
    for k, v in launches.items():
        got1[k] -= v
    expect(got1 == per_run, f"14d: the single run launched {got1}, expected {per_run}")
    first, second = (np.load(os.path.join(root, "records", f)) for f in files)
    single = np.load(os.path.join(root, "one", "gen_latents.npy"))
    expect(np.isfinite(first).all() and np.isfinite(second).all()
           and first.shape == (1, *cli.latent_grid(SIZE, 21), 16), "14d: latents")
    expect(not np.array_equal(first, second), "14d: the two records gave one result")
    same = np.array_equal(first, single)
    print(f"  14d: the first record (seed 60) against the single --prompt run of seed 60: "
          f"equal bit for bit: {same}; the second (seed 61) lies "
          f"{np.linalg.norm(second - first) / np.linalg.norm(first):.3f} from it")
    expect(same, "14d: the first record differs from the single run of its seed")
    del text, t5
    _free(dev)
    return _add(launches, got1)


def phase_solvers(results, root, dev="cuda"):
    """Phase 14: the dpm++ and euler solvers, TeaCache, LoRA merging,
    --transformer_path, --prompt_file and t2i-14B; returns the launches of
    14b-14d (the CLI's paths)."""
    import torch

    dev = torch.device(dev)
    cli = load_script("inference_torch")
    numbers = {}
    _solvers_card_vs_cpu(cli, dev, numbers)
    _free(dev)
    launches = _solvers81(cli, dev, numbers)
    _add(launches, _t2i14(cli, root, dev, numbers))
    _add(launches, _records14(cli, root, dev, numbers))
    print(f"  phase 14 numbers ({CARD}): {json.dumps(numbers)}")
    return launches


# Phase 15: the preprocess CLIs (a video to the latent cache, the captions),
# one PRFL step trained from that cache with the read-ahead on, and the
# whole CLIP checkpoint

SOURCE_CLIP = (122, 720, 1280, 24)  # frames, height, width, fps of the source video
PRE_480 = {  # configs/pre_480.yaml's sizing, in the reference's flat schema
    "resolution": [480], "aspect_ratio": 1.73, "extract_fps": 16, "sample_n_frames": 81,
    "start_idx": 0, "precision": "bf16"}
CACHE_81 = (1, 16, 21, 60, 104)  # the latents of 81 frames at 480 x 832


def write_source_clip(path, n, h, w, fps, seed=91):
    """A textured, moving mp4 through OpenCV: a seeded smooth texture with
    fine grain, panning 2 px a frame, and a white disc crossing it."""
    import cv2

    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (h // 16, (w + 2 * n) // 16 + 1, 3), dtype=np.uint8)
    tex = cv2.resize(low, (low.shape[1] * 16, h), interpolation=cv2.INTER_CUBIC)
    tex = cv2.add(tex, rng.integers(0, 40, tex.shape, dtype=np.uint8))
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    expect(vw.isOpened(), "OpenCV cannot open an mp4 writer")
    for i in range(n):
        f = np.ascontiguousarray(tex[:, 2 * i:2 * i + w])
        cv2.circle(f, (40 + i * (w - 80) // n, h // 2), h // 8, (255, 255, 255), -1)
        vw.write(f)
    vw.release()
    return path


def _pair(label, got, ref, bound_rel):
    """A report_many check of two numpy arrays."""
    import torch

    return label, torch.from_numpy(np.asarray(got)), torch.from_numpy(np.asarray(ref)), bound_rel


def _gen15(gen, cap, root, dev, vae_path, numbers):
    """15a and 15b: the source clip, then gen_latents_torch.main on it at
    pre_480.yaml's sizing, with the seeded ViT-H/14 and umT5-XXL handed in;
    returns the manifest's path and the caption encoder."""
    import torch

    from hyvideo_prfl_torch.configs import load_config
    from hyvideo_prfl_torch.models import clip as clip_mod
    from hyvideo_prfl_torch.models import t5 as t5_mod
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.utils.video_io import read_video

    n, h, w, fps = SOURCE_CLIP
    t0 = time.perf_counter()
    src = write_source_clip(os.path.join(root, "source.mp4"), n, h, w, fps)
    frames, fps_out = read_video(src, num_frames=81, target_fps=16)
    print(f"  15a: a {n}-frame {w} x {h} clip at {fps} fps written by OpenCV "
          f"({os.path.getsize(src) / 2**20:.1f} MiB) and read back at 16 fps as "
          f"{frames.shape} in {time.perf_counter() - t0:.2f} s")
    expect(frames.shape == (81, h, w, 3) and fps_out == 16 and frames.std() > 20,
           f"15a: the reader gave {frames.shape} at {fps_out} fps, std {frames.std():.1f}")
    del frames
    clip = clip_mod.init_params(clip_mod.CLIPVisionTower(clip13(), device=dev),
                                torch.Generator(device=dev).manual_seed(86))
    t5cfg = t5_13()
    t5 = t5_mod.init_params(t5_mod.T5Encoder(t5cfg, device=dev),
                            torch.Generator(device=dev).manual_seed(84))
    tokenizer = StubTokenizer(t5cfg.vocab_size)
    embed = cap.T5Embedder(t5, tokenizer)
    record = {"source_id": "fox", "video_path": src,
              "short_caption": "a red fox crosses a field",
              "long_caption": "a red fox crosses a snowy field at dawn while the camera pans "
                              "slowly to the right"}
    with open(os.path.join(root, "clips.json"), "w") as f:
        json.dump([record], f)
    save_dir = os.path.join(root, "cache")
    tree = {"json_path": os.path.join(root, "clips.json"), "save_dir": save_dir,
            "vae_path": vae_path,
            "image_encoder_path": os.path.join(
                root, "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"),
            "text_encoder_path": os.path.join(root, "models_t5_umt5-xxl-enc-bf16.pth"),
            "tokenizer_path": "stub", **PRE_480}
    with open(os.path.join(root, "pre_480.yaml"), "w") as f:
        f.write(yaml_text(tree) + "\n")
    config = load_config(os.path.join(root, "pre_480.yaml"))
    # the towers handed in as phases 13 and 14 hand them (seeded on the card,
    # no multi-GB files); the VAE from its reference file
    hooks = gen.load_clip, gen.make_t5_embedder
    gen.load_clip = lambda path, device: clip
    gen.make_t5_embedder = lambda *args, **kw: embed
    stats = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        rc = gen.main(config, dev.type, stats=stats)
        torch.cuda.synchronize()
        dt, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    finally:
        gen.load_clip, gen.make_t5_embedder = hooks
    expect(rc == 0 and len(stats) == 1, f"15b: gen_latents rc {rc}, {len(stats)} clips done")
    expect(not _build.LAUNCHES, f"15b: the preprocess launched kernels: {dict(_build.LAUNCHES)}")
    (s,) = stats
    numbers.update({f"15b_{k}": v for k, v in s.items() if k.endswith("_s")})
    numbers.update({"15b_main_s": dt, "15b_peak_gib": peak / 2**30})
    print(f"  15b: {CARD}: gen_latents_torch.main, one clip in {s['total_s']:.3f} s: decode "
          f"and resize {s['read_resize_s']:.3f}, VAE encode {s['encode_s']:.3f}, f1_black "
          f"encode {s['f1_black_s']:.3f}, CLIP {s['clip_s']:.4f}, umT5 on both captions "
          f"{s['t5_s']:.4f}; main {dt:.3f} s with the VAE's load; peak device memory "
          f"{peak / 2**30:.2f} GiB (ViT-H and umT5-XXL resident)")
    meta_path = os.path.join(save_dir, "meta_v1", "fox_meta_v1.json")
    with open(meta_path) as f:
        meta = json.load(f)
    names = {"vae_latent_path": "fox.npy", "f1_black_path": "fox_f1_black.npy",
             "imgclip_path": "fox_img_clip.npy", "textshort_path": "fox_textshort.npy",
             "textlong_path": "fox_textlong.npy"}
    lat_dir = os.path.join(save_dir, "latents")
    expect(all(meta.get(k) == os.path.join(lat_dir, v) for k, v in names.items())
           and meta["latent_shape"] == list(CACHE_81)
           and all(meta[k] == v for k, v in record.items()), f"15b: the manifest {meta}")
    arrays = {k: np.load(meta[k]) for k in names}
    n_tok = {k: int(tokenizer([record[c]], return_mask=True)[1].sum())
             for k, c in (("textshort_path", "short_caption"), ("textlong_path", "long_caption"))}
    shapes = {"vae_latent_path": CACHE_81, "f1_black_path": CACHE_81,
              "imgclip_path": (1, 257, 1280),
              **{k: (1, n, t5cfg.dim) for k, n in n_tok.items()}}
    for k, a in arrays.items():
        print(f"  15b: {names[k]} {a.dtype} {a.shape}, max|x| {np.abs(a).max():.3f}")
        expect(a.shape == shapes[k] and a.dtype == np.float32 and np.isfinite(a).all(),
               f"15b: {k} {a.dtype} {a.shape}, expected finite float32 {shapes[k]}")
    lat, f1 = arrays["vae_latent_path"], arrays["f1_black_path"]
    # the encoder is causal: the first latent frame sees the first pixel frame
    # alone, which both videos share; the later ones differ (zeros against
    # the moving clip). Bound: the same chunk through the same weights,
    # 1e-4 of max|ref|
    report_many("gen_latents", "the clip's and f1_black's first latent frame",
                [_pair("frame 0", lat[:, :, 0], f1[:, :, 0], 1e-4)])
    later = np.abs(lat[:, :, 1:] - f1[:, :, 1:]).mean() / np.abs(lat[:, :, 1:]).mean()
    print(f"  15b: latent frames 1-20 of the clip and of f1_black differ by {later:.3f} "
          "(mean |difference| over mean |latents|)")
    expect(later > 0.05, "15b: f1_black's later frames equal the clip's")
    del clip, arrays, lat, f1
    return meta_path, embed


def _encode15(gen, vae_path, dev):
    """15c: encode_clip_data on the card against the CPU, a 5-frame 64 x 64
    clip through the published VAE and 2 blocks of ViT-H/14."""
    import copy

    import torch

    from hyvideo_prfl_torch.models import clip as clip_mod
    from hyvideo_prfl_torch.utils import encoders

    cpu_vae = encoders.load_reference_vae(vae_path)
    card_vae = encoders.load_reference_vae(vae_path, dev)
    cpu_clip = clip_mod.init_params(clip_mod.CLIPVisionTower(clip13(num_layers=2)),
                                    torch.Generator().manual_seed(92))
    card_clip = copy.deepcopy(cpu_clip).to(dev)
    video = np.random.default_rng(92).uniform(-1, 1, (5, 64, 64, 3)).astype(np.float32)
    got = gen.encode_clip_data(card_vae, card_clip, video)
    want = gen.encode_clip_data(cpu_vae, cpu_clip, video)
    expect(got[0].shape == (1, 16, 2, 8, 8) and got[2].shape == (1, 257, 1280),
           f"15c: shapes {[a.shape for a in got]}")
    # Bound: phase 13's, fp32 (TF32 off) against fp32, 1e-3 of max|CPU|
    report_many("encode_clip_data", "5 x 64 x 64, card against CPU", [
        _pair(name, g, w, 1e-3) for name, g, w in zip(("latents", "f1_black", "img_clip"),
                                                      got, want)])
    del cpu_vae, card_vae, cpu_clip, card_clip


def _captions15(cap, root, dev, embed, numbers):
    """15d: encode_captions_torch.main over a manifest without text paths,
    with --null_dir; a second run skips it. Returns the null directory."""
    from hyvideo_prfl_torch.configs import SAMPLE_NEG_PROMPT

    meta_dir = os.path.join(root, "captions", "meta_v1")
    lat_dir = os.path.join(root, "captions", "latents")
    os.makedirs(meta_dir)
    os.makedirs(lat_dir)
    meta_path = os.path.join(meta_dir, "boat_meta_v1.json")
    meta = {"source_id": "boat", "vae_latent_path": os.path.join(lat_dir, "boat.npy"),
            "short_caption": "a paper boat", "long_caption": "a paper boat drifts down a rainy "
            "street past parked bicycles"}
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    null_dir = os.path.join(root, "null")
    argv = ["--meta_dir", meta_dir, "--t5_params", "seeded-umt5", "--tokenizer", "stub",
            "--null_dir", null_dir, "--negative_prompt", SAMPLE_NEG_PROMPT, "--device", dev.type]
    make_t5_embedder = cap.make_t5_embedder
    cap.make_t5_embedder = lambda *args, **kw: embed
    try:
        t0 = time.perf_counter()
        rc = cap.main(argv)
        dt = time.perf_counter() - t0
        rc2 = cap.main([a for a in argv if a not in ("--null_dir", null_dir)])
    finally:
        cap.make_t5_embedder = make_t5_embedder
    with open(meta_path) as f:
        out = json.load(f)
    paths = {k: os.path.join(lat_dir, f"boat_{k[:-5]}.npy")
             for k in ("textshort_path", "textlong_path")}
    expect(rc == 0 and {k: out.get(k) for k in paths} == paths
           and all(out[k] == v for k, v in meta.items()), f"15d: rc {rc}, manifest {out}")
    files = {**paths, "null": os.path.join(null_dir, "wanx", "null.npy"),
             "uncond": os.path.join(null_dir, "wanx", "uncond.npy")}
    texts = {"textshort_path": meta["short_caption"], "textlong_path": meta["long_caption"],
             "null": "", "uncond": SAMPLE_NEG_PROMPT}
    stamps = {}
    for k, path in files.items():
        a = np.load(path)
        n = int(embed.tokenizer([texts[k]], return_mask=True)[1].sum())
        print(f"  15d: {os.path.basename(path)} {a.dtype} {a.shape}")
        expect(a.shape == (1, n, 4096) and np.isfinite(a).all(),
               f"15d: {path} {a.shape}, expected (1, {n}, 4096)")
        stamps[k] = os.stat(path).st_mtime_ns
    expect(rc2 == 0 and all(os.stat(files[k]).st_mtime_ns == stamps[k] for k in paths),
           "15d: the second run did not skip the encoded manifest")
    numbers["15d_s"] = dt
    print(f"  15d: encode_captions_torch.main: one manifest and the null texts in {dt:.3f} s; "
          "a second run skipped the manifest")
    return null_dir


def _train15(root, dev, meta_path, null_dir, numbers):
    """15e: one outer i2v PRFL step of phase 11's config at 81 frames, read
    from the cache 15b wrote, the read-ahead on; returns its launches."""
    import threading

    import torch

    from hyvideo_prfl_torch.ops import _build

    cli = load_script("train_prfl_torch")
    lst = os.path.join(root, "cache.list")
    with open(lst, "w") as f:
        f.write(meta_path + "\n")
    cfg_name, changes = PRFL_I2V
    trainer, config, build_s = _build_trainer(cli, published(cfg_name, {
        **changes, "dataset.meta_file_list": [lst], "dataset.null_dir": null_dir,
        "save.output_dir": os.path.join(root, "out")}), dev)
    model = trainer.model
    cfg = model.dit_cfg
    want = expected_train_launches(cfg.num_layers, model.lrm.dit_cfg.num_layers,
                                   int(config.train.fixed_mid), cfg.remat_policy, i2v=True)
    inner, seen, waits = trainer.loader, [], []

    def timed():  # the loader as the step sees it, with its wait timed
        while True:
            t0 = time.perf_counter()
            batch = next(inner)
            waits.append(time.perf_counter() - t0)
            seen.append(batch)
            yield batch

    trainer.loader = timed()
    threads = sum(t.name == "BatchIterator" for t in threading.enumerate())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    (m,) = cli.run(trainer, 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = dict(_build.LAUNCHES)
    ahead = sum(t.name == "BatchIterator" for t in threading.enumerate()) - threads
    (batch,) = seen
    with open(meta_path) as f:
        meta = json.load(f)
    shapes = {k: tuple(v.shape) for k, v in batch.items() if not isinstance(v, list)}
    print(f"  15e: {CARD}: i2v-1.3B trainer built in {build_s:.2f} s; one outer step from the "
          f"port's own cache in {dt:.3f} s: refl_loss {m['refl_loss']:.6f}, reward "
          f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
          f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s; waited {waits[0] * 1e3:.2f} "
          f"ms on the batch iterator; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; batch {shapes}")
    expect(ahead == 1, f"15e: {ahead} read-ahead threads started, expected the loader's one")
    expect(shapes["latents"] == shapes["cond"] == (1, 21, 60, 104, 16)
           and shapes["clip_fea"] == (1, 257, 1280) and shapes["text"] == (1, TEXT_LEN, 4096),
           f"15e: batch shapes {shapes}")
    for key, name in (("latents", "vae_latent_path"), ("cond", "f1_black_path")):
        ref = np.transpose(np.load(meta[name])[0], (1, 2, 3, 0))
        expect(np.array_equal(batch[key][0], ref), f"15e: the batch's {key} is not the cache's")
    for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
        expect(math.isfinite(m[key]), f"15e: {key} is not finite: {m}")
    print(f"  15e: launches {got}, derived {want}")
    expect(got == want, f"15e launches {got}, expected {want}")
    numbers.update({"15e_step_s": dt, "15e_t_refl": m["t_refl"], "15e_t_sft": m["t_sft"],
                    "15e_wait_s": waits[0],
                    "15e_peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    del trainer, model, inner
    _free(dev)
    return got


def _clip15(root, dev, numbers):
    """15f: a whole-CLIP reference file at the published widths (2 blocks in
    each tower, log_scale and the image tower's post_norm and head) read by
    load_reference_clip; its text tower with the head and its image tower
    card against CPU; then a seeded XLM-R large at full depth on the card."""
    import torch

    from hyvideo_prfl_torch.models import clip as clip_mod
    from hyvideo_prfl_torch.models import xlm_roberta as xlmr_mod
    from hyvideo_prfl_torch.utils import encoders

    txt_cfg = xlmr_mod.xlm_roberta_large(num_layers=2)
    whole = clip_mod.XLMRobertaCLIP(clip13(num_layers=2), txt_cfg, post_norm=True,
                                    head_shape=(1280, 1024), txt_out_dim=1024)
    g = torch.Generator().manual_seed(93)
    clip_mod.init_params(whole.visual, g)
    xlmr_mod.init_params(whole.textual, g)
    with torch.no_grad():
        whole.log_scale.fill_(math.log(100.0))
    state = {k: v.numpy() for k, v in whole.state_dict().items()}
    del whole
    t0 = time.perf_counter()
    path = encoders.save_reference(state, os.path.join(
        root, "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"))
    dt_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = encoders.load_reference_clip(path, dev)
    dt_load = time.perf_counter() - t0
    cpu = encoders.load_reference_clip(path)
    back = {k: v.cpu().numpy() for k, v in card.state_dict().items()}
    expect(set(back) == set(state) and all(np.array_equal(back[k], state[k]) for k in state)
           and {"log_scale", "visual.head", "visual.post_norm.weight",
                "textual.head.2.weight"} <= set(state), "15f: the whole CLIP did not round-trip")
    print(f"  15f: a whole-CLIP file of {len(state)} tensors "
          f"({os.path.getsize(path) / 2**30:.2f} GiB: ViT-H/14 and XLM-R large, 2 blocks "
          f"each) written in {dt_save:.2f} s, read onto the card in {dt_load:.2f} s, equal "
          "bit for bit")
    rng = np.random.default_rng(93)
    ids = torch.from_numpy(rng.integers(3, txt_cfg.vocab_size, (2, 77)))
    ids[:, 0] = 0
    ids[1, 30:] = txt_cfg.pad_id  # the second row padded from 30
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 480, 832, 3)).astype(np.float32))
    img = clip_mod.preprocess_frames(img, 224)
    # Bound: fp32 (TF32 off) against fp32, 1e-3 of max|CPU|, as phase 13's towers
    report_many("whole CLIP", "2 + 2 blocks, card against CPU", [
        ("XLM-R tokens (2 x 77, one padded from 30)", card.textual(ids.to(dev)).cpu(),
         cpu.textual(ids), 1e-3),
        ("XLM-R with its head", card.textual.encode_with_head(ids.to(dev)).cpu(),
         cpu.textual.encode_with_head(ids), 1e-3),
        ("ViT-H use_31_block", card.visual(img.to(dev)).cpu(), cpu.visual(img), 1e-3)])
    del card, cpu, state
    _free(dev)
    xl = xlmr_mod.init_params(xlmr_mod.XLMRobertaWithHead(xlmr_mod.xlm_roberta_large(),
                                                          device=dev),
                              torch.Generator(device=dev).manual_seed(94))
    x = ids.to(dev)
    xl.encode_with_head(x)  # warm-up
    out, dt, peak = _timed(lambda: xl.encode_with_head(x), dev)
    n = sum(p.numel() for p in xl.parameters())
    numbers.update({"15f_xlmr_ms": dt * 1e3, "15f_xlmr_peak_gib": peak / 2**30,
                    "15f_save_s": dt_save, "15f_load_s": dt_load})
    print(f"  15f: {CARD}: XLM-R large with its head ({xl.cfg.num_layers} layers, dim "
          f"{xl.cfg.dim}, {n / 1e6:.1f} M fp32 params) on 2 x 77 tokens: {tuple(out.shape)} in "
          f"{dt * 1e3:.2f} ms, peak device memory {peak / 2**30:.2f} GiB")
    expect(tuple(out.shape) == (2, 1024) and bool(torch.isfinite(out).all()),
           f"15f: XLM-R large gave {tuple(out.shape)}")
    del xl
    _free(dev)


def phase_preprocess(results, root, dev="cuda"):
    """Phase 15: the preprocess CLIs and a PRFL step from their cache, then
    the whole CLIP; returns the launches of the training step (15e)."""
    import torch

    dev = torch.device(dev)
    numbers = {}
    gen = load_script("gen_latents_torch")
    cap = load_script("encode_captions_torch")
    _, vae_path = seeded_vae_file(root)  # phase 13's seeded Wan2.1_VAE.pth
    meta_path, embed = _gen15(gen, cap, root, dev, vae_path, numbers)
    _encode15(gen, vae_path, dev)
    null_dir = _captions15(cap, root, dev, embed, numbers)
    del embed
    _free(dev)
    launches = _train15(root, dev, meta_path, null_dir, numbers)
    _clip15(root, dev, numbers)
    print(f"  phase 15 numbers ({CARD}): {json.dumps(numbers)}")
    return launches


def _offload16(root, dev):
    """16a: the AdamW moments offloaded to pinned host memory
    (train.offload_opt_state) on the PAVRM bt step at i2v-14B width: 2
    steps at 21 frames with and without offload, every backward on K5 so
    that two runs can agree bit for bit (K4's dq adds in run order), equal
    in loss and parameters bit for bit; then 2 steps at 81 frames under
    offload (the moments' 26.7 GB off the card) with remat "full", its
    s/step, peak and the moments' host-card round trip timed alone.
    Returns (launches, numbers)."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa

    cli = load_script("train_pavrm_torch")
    total, numbers = {}, {}
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    win, null_dir = write_reward_cache(os.path.join(root, "c21"), 21, n=2, i2v=True, seed=51)
    lose, _ = write_reward_cache(os.path.join(root, "c21"), 21, n=3, i2v=True, seed=52)
    fa.FLASH_MERGED_BWD = False
    try:
        want = _add({}, expected_pavrm_launches(8, "bt", i2v=True, merged_bwd=False), 2)
        ref = None
        for offload in (False, True):
            label = "16a i2v-14B bt 21 frames" + (", moments offloaded" if offload else "")
            trainer, hist, got, peak = _pavrm_run(
                cli, _config(PAVRM_BT_I2V, root, win, null_dir,
                             extra={"train.offload_opt_state": offload},
                             dataset__meta_file_lose_list=[lose]), 2, label, want, dev)
            mu = trainer.state.opt_state["mu"] + trainer.state.opt_state["nu"]
            home = {(m.device.type, m.is_pinned()) for m in mu}
            expect(home == ({("cpu", True)} if offload else {("cuda", False)}),
                   f"{label}: the moments lie in {home}")
            step_s = min(h["step_time"] for h in hist[1:])
            numbers[f"bt21_{'offload' if offload else 'card'}"] = (step_s, peak)
            print(f"  {label}: {step_s:.3f} s/step (the second), peak {peak / 2**30:.2f} GiB; "
                  f"moments on {home}; {CARD}")
            params = [p.detach() for p in trainer.state.params]
            if ref is None:
                ref = (hist, [p.cpu() for p in params])
            else:
                same_m = all(a[k] == b[k] for a, b in zip(ref[0], hist)
                             for k in ("loss", "grad_norm", "acc"))
                same_p = all(torch.equal(p.cpu(), q) for p, q in zip(params, ref[1]))
                print(f"  16a: offloaded against on the card: metrics bitwise equal {same_m}, "
                      f"{len(params)} parameters bitwise equal {same_p}")
                expect(same_m and same_p, "16a: the offloaded step is not the step")
            _add(total, got)
            del trainer, params, mu
            torch.cuda.empty_cache()
        del ref
    finally:
        fa.FLASH_MERGED_BWD = True

    # 81 frames (32,760 tokens) with the moments off the card, and remat
    # "full" in place of the config's "attn": under "attn" the two sides'
    # saved activations alone overflow the card in the second side's
    # forward (71.47 GiB allocated there on an H100 80GB), moments or not
    win, null_dir = write_reward_cache(os.path.join(root, "c81"), 81, n=2, i2v=True, seed=53)
    lose, _ = write_reward_cache(os.path.join(root, "c81"), 81, n=3, i2v=True, seed=54)
    label = "16a i2v-14B bt 81 frames, moments offloaded, remat full"
    trainer, hist, got, peak = _pavrm_run(
        cli, _config(PAVRM_BT_I2V, root, win, null_dir,
                     extra={"train.offload_opt_state": True, "model.remat_policy": "full"},
                     dataset__meta_file_lose_list=[lose]), 2, label,
        _add({}, expected_pavrm_launches(8, "bt", remat_policy="full", i2v=True), 2), dev)
    _add(total, got)
    expect(peak < card_bytes, f"{label}: peak {peak} over the card's {card_bytes}")
    # the moments' round trip of one update, alone: each chunk of 64 to the
    # card and back, as Optimizer._adamw moves them
    moments = trainer.state.opt_state["mu"] + trainer.state.opt_state["nu"]
    nbytes = sum(m.numel() * m.element_size() for m in moments)
    times = []
    for _ in range(2):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        for i in range(0, len(moments), 64):
            chunk = [m.to(dev, non_blocking=True) for m in moments[i:i + 64]]
            for m, c in zip(moments[i:i + 64], chunk):
                m.copy_(c, non_blocking=True)
            del chunk
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    copy_ms = min(times)
    step_s = min(h["step_time"] for h in hist[1:])
    numbers["bt81_offload"] = (step_s, peak)
    numbers["copy_ms"], numbers["copy_bytes"] = copy_ms, nbytes
    print(f"  {label}: {step_s:.3f} s/step (the second; the first {hist[0]['step_time']:.3f}), "
          f"peak {peak / 2**30:.2f} GiB of the card's {card_bytes / 2**30:.2f}; the moments' "
          f"round trip {copy_ms:.1f} ms a step ({nbytes / 1e9:.2f} GB each way, "
          f"{2 * nbytes / copy_ms / 1e6:.1f} GB/s); {CARD}")
    del trainer, moments
    torch.cuda.empty_cache()
    return total, numbers


LATENT_21 = (1, 6, 60, 104, 16)  # a 21-frame 832*480 latent, token-cell channels last
LR16 = 5e-6  # the learning rate of configs/train_prfl_*_480.yaml


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Recording:
    """An optimizer that keeps the raw gradients of its first call (this
    rank's shards, before the clip) and updates as ``tx`` does (also the
    gloo tests' recorder)."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def update(self, params, grads, *args, **kw):
        if self.grads is None:
            self.grads = [g.detach().clone() for g in grads]
        return self.tx.update(params, grads, *args, **kw)


# the key biases of a softmax over keys without position (the text and image
# cross-attention's): every logit of a query moves alike, the exact gradient is 0
ZERO_GRAD16 = ("cross_attn.k.bias", "cross_attn.k_img.bias")
# behind the bf16 context that each block's cross-attention k and v read: its
# gradient sums 2 x blocks bf16 terms, in an order FSDP2's hooks on each
# block's inputs change, so these gradients agree to the 3 roundings of a
# 4-term bf16 sum (3 x 2^-8 of their largest), not to fp32's
CONTEXT16 = ("text_0.", "text_2.", "img_emb.")


def _grad_bounds16(names, base):
    """The bound on each refl gradient's difference from the unwrapped
    step's: 1e-4 of the tensor's largest gradient plus two fp32 ulps of it,
    as tests/test_torch_parallel_train.py holds them against JAX (a key
    bias whose exact gradient is 0: 1e-4 of the step's largest; the
    context's tensors: 3 x 2^-8 of their largest)."""
    top = max(b.abs().max().item() for b in base)
    out = []
    for n, b in zip(names, base):
        scale = top if n.endswith(ZERO_GRAD16) else b.abs().max().item()
        rel = 3 * 2 ** -8 if n.startswith(CONTEXT16) else 1e-4
        out.append(rel * scale + 2 * math.ulp(scale) * 2 ** 29)  # an fp32 ulp
    return out


def _grads_off16(names, got, base, bounds):
    """The worst refl gradient's |diff| over its bound, and its tensor."""
    return max(((a - b).abs().max().item() / bound, n)
               for n, a, b, bound in zip(names, got, base, bounds))


def _params_off16(got, base, grads, bounds, eps=1e-8):
    """The parameters after the refl step's AdamW update against the
    unwrapped run's. AdamW's first update is lr g / (|g| + eps); two
    gradients of one sign, each at least m from 0 and at most ``bound``
    apart, give updates within lr eps bound / (m + eps)^2. Where the
    unwrapped gradient keeps its sign within its bound (m = |g| - bound
    >= bound) and that is under 0.1 lr, the weight must agree within 1e-4
    of it plus 0.1 lr (tests/test_torch_parallel_train.py's rule); any
    other weight may move anywhere in (-lr, lr) on either side, so within
    2 lr. Returns (resolved weights beyond the first bound, unresolved
    weights, their largest |diff| in lr, all weights)."""
    beyond, loose, loose_lr, total = 0, 0, 0.0, 0
    for a, b, gr, bound in zip(got, base, grads, bounds):
        d = (a - b).abs()
        m = gr.abs() - bound
        resolved = (m >= bound) & (eps * bound <= 0.1 * (m + eps) ** 2)
        total += d.numel()
        beyond += int(((d > 1e-4 * b.abs() + 0.1 * LR16) & resolved).sum().item())
        loose += int((~resolved).sum().item())
        if not bool(resolved.all()):
            loose_lr = max(loose_lr, d[~resolved].max().item() / LR16)
    return beyond, loose, loose_lr, total


def _strategies16(dev, g):
    """16b's FSDP2 steps: a 2-block t2v-1.3B PRFL model (8 PRFL steps, mid
    3, seeded, a non-zero head), one refl step and one SFT step at 21
    frames with the same draws, unwrapped and under each FSDP strategy on
    the world of one: the metrics, the refl step's raw gradients and the
    parameters it updates against the unwrapped run's. Returns the
    launches of the sharded runs."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.parallel import sharding
    from hyvideo_prfl_torch.schedulers import flow_match as fm
    from hyvideo_prfl_torch.training import common, prfl
    from hyvideo_prfl_torch.training.pavrm import PavrmConfig

    cfg = wan_dit.t2v_1_3b(num_layers=2, remat_policy="attn")
    pc = PavrmConfig(feature_layer=(2,), trainable_blocks=(0, 1))
    rc = prfl.PrflConfig(inference_steps=8, fixed_mid=3)
    seed_model = prfl.PrflModel(cfg, pc, rc, device=dev)
    wan_dit.init_params(seed_model.dit, torch.Generator(device=dev).manual_seed(161))
    with torch.no_grad():
        seed_model.dit.head.head.weight.normal_(0.0, cfg.dim ** -0.5, generator=g)
    seed_model.lrm.init_params(torch.Generator(device=dev).manual_seed(162))
    weights = ({k: v.clone() for k, v in seed_model.dit.state_dict().items()},
               {k: v.clone() for k, v in seed_model.lrm.state_dict().items()})
    del seed_model
    shape = LATENT_21
    batch = {"latents": torch.randn(shape, device=dev, generator=g),
             "text": torch.randn(1, TEXT_LEN, cfg.text_dim, device=dev, generator=g)}
    sched = fm.train_schedule(1000)
    t, sigma = fm.sample_train_timestep(sched, 1, "uniform", generator=torch.Generator(
        device=dev).manual_seed(163))
    draws = dict(latent0=torch.randn(shape, device=dev, generator=g), t=t, sigma=sigma,
                 noise=torch.randn(shape, device=dev, generator=g))
    mesh = sharding.build_mesh(1, dev)

    def run(strategy):
        model = prfl.PrflModel(cfg, pc, rc, device=dev)
        model.dit.load_state_dict(weights[0])
        model.lrm.load_state_dict(weights[1])
        m = mesh if strategy else None
        layout = prfl.parallelize(model, mesh, strategy) if strategy else None
        tx = Recording(common.make_optimizer(learning_rate=LR16))
        state = common.init_train_state(model.dit, tx, layout)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        state, mr = prfl.make_refl_step(model, tx, m)(state, batch, latent0=draws["latent0"])
        params = [sharding.full_of(p, q).detach().clone()
                  for p, q in zip(state.local_params(), state.params)]
        state, ms = prfl.make_sft_step(model, tx, sched, m)(
            state, batch, t=draws["t"], sigma=draws["sigma"], noise=draws["noise"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        metrics = [float(mr["loss"]), float(mr["reward"]), float(mr["grad_norm"]),
                   float(ms["loss"]), float(ms["grad_norm"])]
        grads = [sharding.full_of(gr, q) for gr, q in zip(tx.grads, state.params)]
        sharded = sum(sharding.is_dtensor(p) for p in state.params)
        return metrics, params, grads, launches, secs, sharded, state.names

    base, base_p, base_g, base_l, secs, _, names = run(None)
    bounds = _grad_bounds16(names, base_g)
    want = _add({}, expected_train_launches(2, 2, 3, merged_bwd=False), 1)
    print(f"  16b unwrapped 2-block t2v-1.3B refl + SFT, 21 frames: {secs:.3f} s; refl_loss "
          f"{base[0]:.6f}, reward {base[1]:.6f}, grad_norm {base[2]:.6e}, sft_loss "
          f"{base[3]:.6f}, sft grad_norm {base[4]:.6e}; launches {base_l}")
    expect(base_l == want, f"16b unwrapped launches {base_l}, expected {want}")
    expect(all(math.isfinite(x) for x in base) and base[2] > 0, f"16b: metrics {base}")
    total = {}
    for strategy in sharding.FSDP_STRATEGIES:
        got, params, grads, launches, secs, sharded, _ = run(strategy)
        same_m = got == base
        same_g = all(torch.equal(a, b) for a, b in zip(grads, base_g))
        same_p = all(torch.equal(a, b) for a, b in zip(params, base_p))
        g_ratio, g_name = _grads_off16(names, grads, base_g, bounds)
        beyond, loose, loose_lr, n_weights = _params_off16(params, base_p, base_g, bounds)
        print(f"  16b FSDP2 {strategy} at world 1 over NCCL ({sharded} DTensor parameters): "
              f"{secs:.3f} s; bitwise equal to the unwrapped step: metrics {same_m}, refl "
              f"gradients {same_g}, refl-updated parameters {same_p}; the worst refl gradient "
              f"at {g_ratio:.3e} of its bound ({g_name}); {beyond} resolved weights beyond "
              f"1e-4 + 0.1 lr; {loose:,} of {n_weights:,} weights with gradients their bounds do "
              f"not resolve, max |diff| {loose_lr:.3f} lr; launches {launches}")
        expect(launches == want, f"16b {strategy}: launches {launches}, expected {want}")
        expect((sharded > 0) == (strategy != "none"), f"16b {strategy}: {sharded} DTensors")
        # FSDP2's hooks on each wrapped block's inputs reorder the sums of
        # the activation gradients the blocks share (the time embedding, the
        # context): bitwise where that order holds ("none"), else the refl
        # forward bitwise, its gradient norm within 1e-5, its gradients and
        # the parameters it updates as _grad_bounds16 and _params_off16 hold
        # them, and the SFT metrics, which read those parameters, within 1e-3
        expect(same_m or (got[:2] == base[:2] and abs(got[2] - base[2]) <= 1e-5 * base[2]
                          and all(abs(a - b) <= 1e-3 * abs(b)
                                  for a, b in zip(got[3:], base[3:]))),
               f"16b {strategy}: metrics {got} against {base}")
        expect(strategy != "none" or (same_m and same_g and same_p),
               "16b none: not the unwrapped step bit for bit")
        expect(g_ratio <= 1.0, f"16b {strategy}: refl gradient {g_name} at {g_ratio:.3e} of "
                               f"its bound")
        expect(beyond == 0 and loose_lr <= 2, f"16b {strategy}: {beyond} resolved weights "
               f"beyond 1e-4 + 0.1 lr; unresolved ones up to {loose_lr:.3f} lr apart")
        del params, grads
        _add(total, launches)
    return total


def _serving16(dev, mesh, g):
    """16b: shard_for_serving on a 2-block t2v-1.3B DiT in its serving
    storage (bf16 matmul weights, fp32 gains): no parameter recast, each
    block's bf16 weights sharded and its fp32 ones whole, and the forward
    on a 21-frame latent bit for bit the unsharded one."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.parallel import sharding

    model = wan_dit.WanModel(wan_dit.t2v_1_3b(num_layers=2), device=dev)
    wan_dit.init_params(model, torch.Generator(device=dev).manual_seed(164))
    model.eval()
    before = {n: p.dtype for n, p in model.named_parameters()}
    x = torch.randn(LATENT_21, device=dev, generator=g)
    ctx = torch.randn(1, TEXT_LEN, model.cfg.text_dim, device=dev, generator=g)
    t = torch.tensor([700.0], device=dev)
    with torch.no_grad():
        want = model(x, t, ctx)
        sharding.shard_for_serving(model, mesh)
        got = model(x, t, ctx)
    params = dict(model.named_parameters())
    recast = [n for n, dt in before.items() if params[n].dtype != dt]
    wrong = [n for n, p in params.items() if sharding.is_dtensor(p) != (
        n.startswith("blocks.") and p.dtype == torch.bfloat16)]
    n_sharded = sum(sharding.is_dtensor(p) for p in params.values())
    same = torch.equal(got, want)
    print(f"  16b shard_for_serving, 2-block t2v-1.3B in bf16 storage: {n_sharded} bf16 block "
          f"weights sharded, {len(recast)} recast, {len(wrong)} misplaced; the forward bitwise "
          f"equal to the unsharded one {same}")
    expect(not recast and not wrong and n_sharded > 0,
           f"16b shard_for_serving: recast {recast[:3]}, misplaced {wrong[:3]}")
    expect(same, "16b shard_for_serving: the forward is not the unsharded one")


def _nccl16(root, dev):
    """16b: the process group of one rank over NCCL, in this process: the
    five FSDP strategies' steps against the unwrapped one (_strategies16);
    ulysses_attention at degree 1 forward and backward against the plain
    dot_product_attention call; shard_for_serving on a bf16-stored DiT
    (_serving16); configs/train_prfl_t2v_480.yaml (phase 7's
    changes) with dataset.sp_size 4 through train_prfl_torch.main for one
    21-frame outer step, whose sp clamps to 1 as JAX's build_mesh clamps
    it, against the same run at sp_size 1, every backward on K5 so the two
    can agree bit for bit. Torn down at the end. Returns the launches."""
    import torch
    import torch.distributed as dist

    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops.attention import dot_product_attention, ulysses_attention
    from hyvideo_prfl_torch.parallel import sharding

    g = torch.Generator(device=dev).manual_seed(160)
    t0 = time.perf_counter()
    # NCCL on the card; gloo only in a CPU rehearsal of the phase
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    print(f"  16b: a process group of one started in {time.perf_counter() - t0:.2f} s "
          f"(backend {dist.get_backend()})")
    total = {}
    fa.FLASH_MERGED_BWD = False
    try:
        _add(total, _strategies16(dev, g))

        mesh = sharding.build_mesh(1, dev)
        sp1 = sharding.SeqParallel(mesh.group("sp"), 1, 0)
        n, lq = 12, math.prod(LATENT_21[1:4]) // 4
        q, k = (torch.randn(1, n, lq, 128, device=dev, generator=g).bfloat16()
                .requires_grad_() for _ in range(2))
        v = torch.randn(1, lq, n, 128, device=dev, generator=g).bfloat16().requires_grad_()
        do = torch.randn(1, lq, n, 128, device=dev, generator=g).bfloat16()
        outs = []
        for fn in (lambda: ulysses_attention(q, k, v, sp1, "bnld", bounded_logits=True),
                   lambda: dot_product_attention(q, k, v, qk_layout="bnld",
                                                 bounded_logits=True)):
            o = fn()
            outs.append((o.detach(), *torch.autograd.grad(o, (q, k, v), do)))
        same = [torch.equal(a, b) for a, b in zip(*outs)]
        print(f"  16b ulysses_attention at degree 1, [1, {n}, {lq:,}, 128]: out, dq, dk, dv "
              f"bitwise equal to dot_product_attention: {same}")
        expect(all(same), "16b: ulysses_attention at degree 1 is not the plain call")
        del q, k, v, do, outs
        _serving16(dev, mesh, g)

        cli = load_script("train_prfl_torch")
        lists, null_dir = write_latent_cache(os.path.join(root, "c16b"), (21,))
        hist = {}
        for sp in (4, 1):
            name, changes = PRFL_T2V
            config = published(name, {**changes, "dataset.meta_file_list": [lists[21]],
                                      "dataset.null_dir": null_dir, "dataset.sp_size": sp,
                                      "save.output_dir": os.path.join(root, f"out16b_{sp}")})
            path = os.path.join(root, f"prfl16b_sp{sp}.yaml")
            with open(path, "w") as f:
                f.write(yaml_text(config) + "\n")
            torch.cuda.synchronize()
            _build.reset_launches()
            (m,) = cli.main(["--config_path", path, "--max_steps", "1", "--device", dev.type])
            torch.cuda.synchronize()
            _add(total, dict(_build.LAUNCHES))
            hist[sp] = {k_: v_ for k_, v_ in m.items() if not k_.startswith("t_")}
            print(f"  16b train_prfl_torch.main, train_prfl_t2v_480.yaml at t2v-1.3B, "
                  f"dataset.sp_size {sp}, 21 frames: {hist[sp]}, t_refl {m['t_refl']:.3f} s, "
                  f"t_sft {m['t_sft']:.3f} s; launches {dict(_build.LAUNCHES)}")
        expect(hist[4] == hist[1], f"16b: sp_size 4 on one rank {hist[4]} is not sp_size 1's "
                                   f"{hist[1]}")
    finally:
        fa.FLASH_MERGED_BWD = True
        dist.destroy_process_group()
    expect(not dist.is_initialized(), "16b: the process group outlived the phase")
    return total


def phase_multi(results, root, dev="cuda"):
    """Phase 16: the multi-GPU layer on one card: 16a optimizer-state
    offload, 16b the NCCL world of one (FSDP2 strategies, Ulysses at
    degree 1, the sp_size-4 config through the CLI), 16c the kernels at
    the shapes sp 4 gives them. Returns the launches."""
    import torch

    dev = torch.device(dev)
    total = {}
    announce("  16a: optimizer-state offload, PAVRM bt at i2v-14B width")
    part, numbers = _offload16(root, dev)
    _add(total, part)
    announce("  16b: NCCL at world size 1: FSDP2 strategies, Ulysses, sp_size 4 through the CLI")
    _add(total, _nccl16(root, dev))
    announce("  16c: the kernels at the sp=4 shard shapes of t2v-14B at 720*1280, 81 frames")
    g = torch.Generator(device=dev).manual_seed(1616)
    lq = math.prod(GRID_14B_81)
    # two turns, not three: the plain backward takes seconds at 75,600 keys
    _attn_kernels_at(results, "K1", "sp4_self", 10, lq, lq,
                     "Ulysses self-attention, 40 heads / 4", g, "16c", k5=False, reps=2)
    _attn_kernels_at(results, "K3", "sp4_text", 40, lq // 4, TEXT_LEN,
                     "token-parallel text cross-attention, 75,600 / 4 queries", g, "16c",
                     k5=False)
    _norm_kernels_at(results, "sp4_d5120", 40, GRID_14B_81, g, shard=4)
    return total


# -- phase 17: LoRA training, the ring, the matmul-keeping remat, the clamp, the logger -----


def _lora_grads17(dev, rank=128, seed=171):
    """17a card against CPU: a 2-block t2v-1.3B DiT at one latent frame of
    832*480 (1,560 tokens) with seeded rank-``rank`` factors attached
    (non-zero B, so A has a gradient): the factors' gradients on the card
    and on the CPU at bf16 compute, and on the CPU at fp32 (phase 6's
    bounds: 2e-2 of each gradient's norm against the CPU bf16 run)."""
    import torch

    from hyvideo_prfl_torch.models import wan_dit
    from hyvideo_prfl_torch.training import lora as lora_mod
    from hyvideo_prfl_torch.utils.checkpoint import from_jax_params, seeded_jax_tree

    cfg = wan_dit.t2v_1_3b(num_layers=2, remat_policy="attn")
    state = from_jax_params(seeded_jax_tree(cfg, seed=seed), cfg)
    tree = seeded_lora(cfg, rank, seed, torch.device("cpu"))
    rng = np.random.default_rng(seed + 1)
    f, hh, ww = GRID_14B_1[0], GRID_14B_1[1] * 2, GRID_14B_1[2] * 2
    x = torch.from_numpy(rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, TEXT_LEN, cfg.text_dim), dtype=np.float32))
    r = torch.from_numpy(rng.standard_normal((1, f, hh, ww, 16), dtype=np.float32))
    grads = {}
    for key, d, cd in (("card", dev, torch.bfloat16), ("cpu", torch.device("cpu"), torch.bfloat16),
                       ("cpu fp32", torch.device("cpu"), torch.float32)):
        model = wan_dit.WanModel(dataclasses.replace(cfg, compute_dtype=cd), device=d,
                                 param_dtype=torch.float32)
        model.load_state_dict(state)
        lora_mod.attach_lora(model, tree)
        out = model(x.to(d), torch.tensor([700.0], device=d), ctx.to(d))
        (out * r.to(d)).sum().backward()
        grads[key] = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                      if p.requires_grad}
        expect(all(p.grad is None for p in model.parameters() if not p.requires_grad),
               "17a: a frozen base weight got a gradient")
        del model, out
    worst = max((_rel(grads["card"][n], g), n) for n, g in grads["cpu"].items())
    noise = max(_rel(g, grads["cpu fp32"][n]) for n, g in grads["cpu"].items())
    print(f"  17a card against CPU, 2 blocks, 1,560 tokens, rank {rank}: {len(grads['cpu'])} "
          f"factor gradients; the largest relative error {worst[0]:.3e} ({worst[1]}; bound "
          f"2e-2); the CPU bf16 run against fp32 at most {noise:.3e}")
    expect(worst[0] <= 2e-2, f"17a: LoRA gradient {worst[1]} off by {worst[0]:.3e}")
    torch.cuda.empty_cache()


def _lora17(root, dev):
    """17a: phase 7's config with model.lora.use_lora (rank 128, q/k/v/o)
    and EMA on through train_prfl_torch: one outer step at 21 frames and
    one at 81, saved after the second; returns the launches."""
    import torch

    from hyvideo_prfl_torch.data.dataset import LatentCacheDataset
    from hyvideo_prfl_torch.data.loader import BatchIterator, BlockDistributedSampler
    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.training import lora as lora_mod
    from hyvideo_prfl_torch.utils import checkpoint as ck
    from hyvideo_prfl_torch.utils import safetensors_io

    cli = load_script("train_prfl_torch")
    lists, null_dir = write_latent_cache(os.path.join(root, "c17a"), (21, 81))
    name, changes = PRFL_T2V
    out = os.path.join(root, "out17a")
    config = published(name, {**changes, "dataset.meta_file_list": [lists[21]],
                              "dataset.null_dir": null_dir, "save.output_dir": out,
                              "model.lora.use_lora": True, "model.lora.lora_rank": 128,
                              "model.lora.target_modules": ["q", "k", "v", "o"],
                              "model.ema.use_ema": True, "train.save_interval": 2})
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    trainer, config, build_s = _build_trainer(cli, config, dev)
    model, cfg = trainer.model, trainer.model.dit_cfg
    n_trained = sum(p.numel() for p in trainer.state.params)
    n_base = sum(p.numel() for n, p in model.dit.named_parameters()
                 if not lora_mod.is_lora_name(n))
    print(f"  17a LoRA trainer built in {build_s:.2f} s: {len(trainer.state.names)} factors, "
          f"{n_trained / 1e6:.2f} M trained of {n_base / 1e9:.3f} B frozen; AdamW moments "
          f"{sum(m.numel() for m in trainer.state.opt_state['mu']) / 1e6:.2f} M a moment; it "
          f"holds {(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held before it")
    expect(all(lora_mod.is_lora_name(n) for n in trainer.state.names)
           and len(trainer.state.names) == 2 * 2 * 4 * cfg.num_layers, "17a: trained names")
    # the base's copy in host memory, so that the peaks are the trainer's own
    base = {n: p.detach().cpu() for n, p in model.dit.named_parameters()
            if not lora_mod.is_lora_name(n)}
    b_before = model.dit.blocks[-1].self_attn.q.lora_B.detach().clone()
    per_step = expected_train_launches(cfg.num_layers, model.lrm.dit_cfg.num_layers,
                                       int(config.train.fixed_mid), cfg.remat_policy, lora=True)
    ds81 = LatentCacheDataset([lists[81]], uncond_prob=[0.1, 0.0], text_len=512,
                              null_dir=null_dir, seed=1)
    total = {}
    for frames in (21, 81):
        if frames == 81:
            trainer.loader = iter(BatchIterator(ds81, BlockDistributedSampler(len(ds81))))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        (m,) = cli.run(trainer, 1)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        _add(total, launches)
        print(f"  17a LoRA, {frames} frames: refl_loss {m['refl_loss']:.6f}, reward "
              f"{m['reward']:.6f}, grad_norm {m['grad_norm']:.6e}, sft_loss {m['sft_loss']:.6f}, "
              f"t_refl {m['t_refl']:.3f} s, t_sft {m['t_sft']:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} above what was held "
              f"before the trainer; {CARD}")
        for key in ("refl_loss", "reward", "grad_norm", "sft_loss"):
            expect(math.isfinite(m[key]), f"17a: {key} is not finite: {m}")
        expect(m["grad_norm"] > 0, f"17a: grad norm {m['grad_norm']} is not above 0")
        expect(launches == per_step, f"17a: launches {launches}, expected {per_step}")
    moved = (model.dit.blocks[-1].self_attn.q.lora_B.detach() != b_before).float().mean().item()
    same = all(torch.equal(p.detach().cpu(), base[n]) for n, p in model.dit.named_parameters()
               if not lora_mod.is_lora_name(n))
    print(f"  17a: the base bit for bit unchanged: {same}; the last block's self_attn.q.lora_B: "
          f"{moved:.1%} of its entries moved")
    expect(same, "17a: a frozen base weight moved")
    expect(moved > 0, "17a: B did not move")

    ckpt = os.path.join(out, config.train_id, "checkpoint-2")
    files = sorted(os.listdir(ckpt))
    want = [f"lora_{f}.safetensors" for f in ("diffusers", "kohya", "transformer")]
    print(f"  17a: {ckpt} holds {files}")
    # the merged DiT in the reference layout: one file, or 5 GB shards and their index
    expect(all(f in files for f in want) and "opt_state" not in files
           and any(f.startswith("diffusion_pytorch_model") for f in files), f"17a: files {files}")
    expect(os.path.isdir(os.path.join(out, config.train_id + "-ema", "checkpoint-2")),
           "17a: no EMA checkpoint")
    t0 = time.perf_counter()
    saved = ck.load_reference_dir(ckpt, cfg)
    tree = lora_mod.lora_from_state_dict(
        safetensors_io.read_file(os.path.join(ckpt, "lora_transformer.safetensors")),
        head_dim=cfg.head_dim)
    want_state = lora_mod.merged_state(base, tree)
    worst = max(float((saved[k] - v).abs().max()) for k, v in want_state.items())
    print(f"  17a: the merged checkpoint against base + A B of the saved factors: max abs "
          f"difference {worst:.3e} over {len(want_state)} tensors ({time.perf_counter() - t0:.2f}"
          f" s to read and merge)")
    expect(worst == 0.0, f"17a: the merged checkpoint is {worst} off base + A B")
    del trainer, model, saved, want_state, base
    torch.cuda.empty_cache()
    _lora_grads17(dev)
    return total


def _ring_case17(label, q, k, v, do, r, bounded, plain_heads=2):
    """The ring of ``r`` virtual ranks (LocalRing) on q, k [B, N, L, D] and
    v, do [B, L, N, D], forward and backward, against the whole-sequence
    kernels (K1/K3 or K2/K3s, K4 or K5) and, on batch 0's first
    ``plain_heads`` heads, the plain versions. Bounds: o within 2^-6 of
    max|o| (phase 2's), dq/dk/dv within 2^-5 of their largest (two bf16
    roundings a hop: each hop's partial is rounded before the fp32 sum).
    Returns (launches of the ring's forward and backward, seconds)."""
    import torch

    from hyvideo_prfl_torch.ops import _build
    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import ring_attention as ra

    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    o = ra.ring_attention(*xs, ra.LocalRing(r), qk_layout="bnld", bounded_logits=bounded)
    grads = torch.autograd.grad(o, xs, do)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    ow = fa.flash_attention(*ys, qk_layout="bnld", bounded_logits=bounded)
    gw = torch.autograd.grad(ow, ys, do)
    checks = [("o", o, ow, 2.0 ** -6)] + [(n, a, b, 2.0 ** -5)
                                           for n, a, b in zip(("dq", "dk", "dv"), grads, gw)]
    report_many("ring", f"{label} against the whole-sequence kernels", checks)
    del ow, gw, ys
    h = slice(0, plain_heads)
    qh, kh, vh, doh = q[:1, h], k[:1, h], v[:1, :, h], do[:1, :, h]
    po, plse = (fa.flash_attention_plain(qh, kh, vh) if bounded
                else fa.flash_attention_shifted_plain(qh, kh, vh))
    pg = fa.flash_attention_bwd_plain(qh, kh, vh, po, plse, doh)
    checks = [("o", o[:1, :, h], po, 2.0 ** -6)] + [
        (n, a, b, 2.0 ** -5) for n, a, b in zip(
            ("dq", "dk", "dv"), (grads[0][:1, h], grads[1][:1, h], grads[2][:1, :, h]), pg)]
    report_many("ring", f"{label}, batch 0, heads 0-{plain_heads - 1}, against the plain "
                f"versions", checks)
    print(f"  17b {label}: ring forward + backward {dt * 1e3:.1f} ms wall (first call); "
          f"launches {launches}")
    del o, grads, po, plse, pg, xs
    torch.cuda.empty_cache()
    return launches


def _hop_times17(results, tag, q, k, v, do, r, bounded, merged=True):
    """One hop of the ring at its real shape (rank 0's queries against one
    key block) timed in turns: the forward (_block_attention_with_lse), the
    merge and the backward (_block_bwd), beside the forward's and the
    backward's bounds; recorded under the kernels' ``tag``."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa
    from hyvideo_prfl_torch.ops import ring_attention as ra

    b, n, l, d = q.shape
    lq = lk = l // r
    qr, kr, vr, dor = q[:, :, :lq], k[:, :, lk:2 * lk], v[:, lk:2 * lk], do[:, :lq]
    o, lse = ra._block_attention_with_lse(qr, kr, vr, bounded)
    o16 = o.to(q.dtype)
    fwd = ("K3" if fa.uses_single_block(lk) else "K1") if bounded else \
        ("K3s" if fa.uses_single_block(lk) else "K2")
    bwd = "K4" if merged else "K5"
    t = timed_turns({"fwd": lambda: ra._block_attention_with_lse(qr, kr, vr, bounded),
                     "merge": lambda: ra._merge(o, lse, o, lse),
                     "bwd": lambda: fa.bwd_kernel(qr, kr, vr, o16, lse, dor, merged)},
                    reps=3, calls=2)
    bf = bound(2 * b * n * (lq + lk) * d * 2, bf16=4 * b * n * lq * lk * d)
    bb = bound(b * n * d * 2 * (3 * lq + 4 * lk) + 8 * b * n * lq, bf16=10 * b * n * lq * lk * d)
    print(f"  17b {tag}: one hop of {r}, [{b}, {n}, {lq:,} x {lk:,}, 128]: {fwd} {t['fwd']:.4f}"
          f" ms ({bf['bound_ms'] / t['fwd']:.3f} of its {bf['bound_ms']:.4f} ms bound), the "
          f"merge {t['merge']:.4f} ms, {bwd} {t['bwd']:.4f} ms ({bb['bound_ms'] / t['bwd']:.3f} "
          f"of its {bb['bound_ms']:.4f} ms bound); {CARD}")
    results[fwd][f"{tag}_hop_ms"] = t["fwd"]
    results[fwd][f"{tag}_hop_bound_ms"] = bf["bound_ms"]
    results[bwd][f"{tag}_hop_ms"] = t["bwd"]
    results[bwd][f"{tag}_hop_bound_ms"] = bb["bound_ms"]
    results[fwd][f"{tag}_merge_ms"] = t["merge"]
    del o, o16, lse
    torch.cuda.empty_cache()


def _ring17(results, dev):
    """17b: the ring on one card through the port's own ring functions with
    a local rotation (r virtual ranks). The t2v-14B 720*1280, 81-frame USP
    shard at ring 2 x Ulysses 4 on 8 GPUs: batch 2 (CFG), 10 heads, 37,800
    queries a rank, 75,600 keys in 2 blocks (r = 2, K1 and K4 per hop) and
    the same sequence over r = 4 (18,900 a rank); the shifted route (K2, and
    K5 under HYV_FLASH_MERGED_BWD=0) at 18,900 tokens over r = 2; K3 hops
    at t2v-1.3B's 21-frame self-attention (2 x 12 heads x 9,360) over r = 4
    (2,340 keys a hop). Returns the launches."""
    import torch

    from hyvideo_prfl_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(172)

    def qkv(b, n, l):
        return (torch.randn(b, n, l, 128, device=dev, generator=g).bfloat16(),
                torch.randn(b, n, l, 128, device=dev, generator=g).bfloat16(),
                torch.randn(b, l, n, 128, device=dev, generator=g).bfloat16(),
                torch.randn(b, l, n, 128, device=dev, generator=g).bfloat16())

    total = {}
    q, k, v, do = qkv(2, 10, 75_600)
    for r in (2, 4):
        launches = _ring_case17(f"r = {r}, [2, 10, 75,600, 128]", q, k, v, do, r, True)
        expect(launches == {"K1": r * r, "K4": r * r},
               f"17b r = {r}: launches {launches}, expected K1 and K4 {r} x {r}")
        _add(total, launches)
    _hop_times17(results, "ring17", q, k, v, do, 2, True)
    del q, k, v, do
    q, k, v, do = qkv(2, 10, 18_900)
    fa.FLASH_MERGED_BWD = False
    try:
        launches = _ring_case17("shifted, r = 2, [2, 10, 18,900, 128]", q, k, v, do, 2, False)
        expect(launches == {"K2": 4, "K5": 4}, f"17b shifted: launches {launches}")
        _add(total, launches)
        _hop_times17(results, "ring17_shifted", q, k, v, do, 2, False, merged=False)
    finally:
        fa.FLASH_MERGED_BWD = True
    del q, k, v, do
    q, k, v, do = qkv(2, 12, 9_360)
    launches = _ring_case17("r = 4, [2, 12, 9,360, 128]", q, k, v, do, 4, True)
    expect(launches.get("K3") == 16, f"17b K3 hops: launches {launches}")
    _add(total, launches)
    del q, k, v, do
    torch.cuda.empty_cache()
    return total


def _remat17(root, dev):
    """17c: phase 7's config at 21 frames, two outer steps under remat
    "attn" and two under "dots_all", from the same weights, data and
    draws: the first step's reward the same (the forward does not depend
    on remat) and its grad norm within 1% (K4's dq adds in run order); the
    warm second step's times and the peak of each. Returns the launches."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    cli = load_script("train_prfl_torch")
    lists, null_dir = write_latent_cache(os.path.join(root, "c17c"), (21,))
    name, changes = PRFL_T2V
    runs, total = {}, {}
    for policy in ("attn", "dots_all"):
        config = published(name, {**changes, "dataset.meta_file_list": [lists[21]],
                                   "dataset.null_dir": null_dir, "model.remat_policy": policy,
                                   "save.output_dir": os.path.join(root, f"out17c_{policy}")})
        trainer, config, _ = _build_trainer(cli, config, dev)
        expect(trainer.model.dit_cfg.remat_policy == policy, f"17c: remat {policy} not taken")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        m, warm = cli.run(trainer, 2)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        _add(total, dict(_build.LAUNCHES))
        runs[policy] = m
        print(f"  17c remat {policy!r}, 21 frames: first step reward {m['reward']:.6f}, "
              f"grad_norm {m['grad_norm']:.6e}, t_refl {m['t_refl']:.3f} s, t_sft "
              f"{m['t_sft']:.3f} s; second step t_refl {warm['t_refl']:.3f} s, t_sft "
              f"{warm['t_sft']:.3f} s; peak {peak / 2**30:.2f} GiB; launches over both "
              f"{dict(_build.LAUNCHES)}; {CARD}")
        del trainer
        torch.cuda.empty_cache()
    a, d = runs["attn"], runs["dots_all"]
    g = abs(d["grad_norm"] / a["grad_norm"] - 1)
    expect(d["reward"] == a["reward"] and math.isfinite(d["sft_loss"]),
           f"17c: dots_all's reward {d['reward']} is not attn's {a['reward']}")
    expect(g <= 0.01, f"17c: dots_all's grad norm lies {g:.3e} from attn's")
    print(f"  17c: reward equal; grad norm {g:.2e} relative apart (bound 0.01)")
    return total


def _clamp17(root, dev):
    """17d: inference_torch.main --ring_size 2 on one card runs ring 1 (the
    JAX clamp), and its latents are --ring_size 1's bit for bit. Returns
    the launches."""
    import torch

    from hyvideo_prfl_torch.ops import _build

    cli = load_script("inference_torch")
    lat, total = {}, {}
    for ring in (2, 1):
        save = os.path.join(root, f"ring{ring}.mp4")
        _build.reset_launches()
        rc, dt, _ = _timed(lambda: cli.main(
            ["--task", "t2v-1.3B", "--size", SIZE, "--frame_num", "21", "--sample_steps", "2",
             "--ring_size", str(ring), "--save_file", save, "--device", dev.type]), dev)
        _add(total, dict(_build.LAUNCHES))
        expect(rc == 0, f"17d: --ring_size {ring} exited {rc}")
        lat[ring] = np.load(os.path.join(root, f"ring{ring}_latents.npy"))
        print(f"  17d: inference_torch.main --ring_size {ring}, t2v-1.3B, 21 frames, 2 steps: "
              f"{dt:.3f} s, latents {lat[ring].shape}; launches {dict(_build.LAUNCHES)}")
    same = np.array_equal(lat[2], lat[1])
    print(f"  17d: --ring_size 2 clamped to ring 1 on one card: latents bit for bit those of "
          f"--ring_size 1: {same}")
    expect(same and np.isfinite(lat[1]).all(), "17d: --ring_size 2 on one card differs")
    torch.cuda.empty_cache()
    return total


def _logger17(root):
    """17e: the trainers' metric logger writes TensorBoard scalars where
    torch.utils.tensorboard imports, and keeps to log.txt otherwise."""
    from hyvideo_prfl_torch.configs import config_from_dict
    from hyvideo_prfl_torch.training import cli as tcli

    log_dir = os.path.join(root, "logs17")
    log = tcli.MetricLogger(config_from_dict({"save": {"log_dir": log_dir}}), root)
    tensorboard = log.writer is not None
    log.log({"step": 0, "refl_loss": 0.5}, 0, {"refl_loss": 0.5})
    log.close()
    events = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
    with open(os.path.join(log_dir, "log.txt")) as f:
        lines = f.read().splitlines()
    print(f"  17e: log.txt {lines}; "
          + (f"TensorBoard event file {events}" if tensorboard else
             "torch.utils.tensorboard does not import here: text only"))
    expect(lines == [json.dumps({"step": 0, "refl_loss": 0.5})], "17e: log.txt")
    expect(bool(events) == tensorboard, f"17e: event files {events}, writer {tensorboard}")


def phase_rest(results, root, dev="cuda"):
    """Phase 17: 17a LoRA PRFL training, 17b the ring on one card, 17c the
    "dots_all" remat policy, 17d the serving CLI's --ring_size clamp, 17e
    the metric logger. Returns the launches."""
    import torch

    dev = torch.device(dev)
    total = {}
    t0 = time.perf_counter()
    _add(total, _lora17(root, dev))
    print(f"  17a in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(total, _ring17(results, dev))
    print(f"  17b in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(total, _remat17(root, dev))
    print(f"  17c in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(total, _clamp17(root, dev))
    print(f"  17d in {time.perf_counter() - t0:.1f} s")
    _logger17(root)
    return total


def print_clocks(when: str) -> None:
    """The card's SM clock, its maximum, temperature and power draw as
    nvidia-smi reads them (a card that runs slow shows it here)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
                          "power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card {when}: SM clock, max SM clock, temperature, power: "
          f"{out.stdout.strip() or out.stderr.strip()}")


def print_ptxas(log: str, smem: dict) -> None:
    """Registers and spills of the kernel instances the slice launches, any
    ptxas warning about them (a serialised wgmma pipeline, an ignored
    setmaxnreg), and the dynamic shared memory per block of the TMA/wgmma
    kernels (``smem``: name -> bytes). The
    norm kernels' instances: K6/K8's narrow rows (a warp each) under a
    ceiling of 12 (K8) or 6 (K6) chunks a lane, filled exactly at D 1536 /
    12 heads (a compile-time count) and not at D 1280 / 10 heads, and wide
    rows (a block each) at D 5120 / 40 heads; K7 one ring kernel for every
    width, with rope and without; K9 one ring kernel for every width, per g
    type."""
    wanted = {"flash_fwd_kernelILb0ELb1E": "K1",
              "flash_fwd_kernelILb0ELb0E": "K3",
              "flash_fwd_kernelILb1ELb1E": "K2",
              "flash_fwd_kernelILb1ELb0E": "K3s",
              "rope_kernelI13__nv_bfloat16E": "R bf16",
              "rope_kernelIfE": "R fp32",
              "flash_bwd_merged_kernel": "K4",
              "flash_bwd_prologue_kernelILb0E": "K4 prologue",
              "flash_bwd_prologue_kernelILb1E": "K5 prologue",
              "flash_bwd_dkv_kernel": "K5 dk/dv",
              "flash_bwd_dq_kernel": "K5 dq",
              "rmsnorm_rope_bwd_kernelILb1E": "K7 rope",
              "rmsnorm_rope_bwd_kernelILb0E": "K7 norm-only",
              "ln_scale_shift_bwd_kernelI13__nv_bfloat16E": "K9 bf16-g",
              "ln_scale_shift_bwd_kernelIfE": "K9 fp32-g",
              "ln_scale_shift_kernelILi1ELi12ELb1E13__nv_bfloat16": "K8 narrow D=1536 bf16-out",
              "ln_scale_shift_kernelILi1ELi12ELb1Ef": "K8 narrow D=1536 fp32-out",
              "ln_scale_shift_kernelILi1ELi12ELb0E13__nv_bfloat16": "K8 narrow D=1280 bf16-out",
              "ln_scale_shift_kernelILi8ELi8ELb0E13__nv_bfloat16": "K8 wide bf16-out",
              "ln_scale_shift_kernelILi8ELi8ELb0Ef": "K8 wide fp32-out",
              "rmsnorm_rope_kernelILi1ELi6ELb1ELb1": "K6 narrow 12 heads rope",
              "rmsnorm_rope_kernelILi1ELi6ELb1ELb0": "K6 narrow 12 heads norm-only",
              "rmsnorm_rope_kernelILi1ELi6ELb0ELb1": "K6 narrow 10 heads rope",
              "rmsnorm_rope_kernelILi8ELi4ELb0ELb1": "K6 wide rope",
              "rmsnorm_rope_kernelILi8ELi4ELb0ELb0": "K6 wide norm-only",
              "flash_fwd_qk8_kernel": "K10",
              "probe_kernelILb1E": "P1/P2 int8",
              "probe_kernelILb0E": "P1/P2 bf16"}
    current = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = next((v for k, v in wanted.items() if k in line), None)
        elif "Performance Loss" in line or "arning" in line:
            print(f"  ptxas: {line.split(':', 1)[-1].strip()}")
        elif "(C75" in line:  # a note on a wgmma pipeline, naming its function
            named = next((v for k, v in wanted.items() if k in line), "another kernel")
            print(f"  ptxas note on {named}: {line.split(':', 1)[-1].split(' in function')[0].strip()}")
        elif current and ("registers" in line or "spill" in line):
            print(f"  ptxas {current}: {line.split(':', 1)[-1].strip()}")
            # the TMA/wgmma kernels (K7's ring and the probes too) and the
            # norm kernels' wide row layout must not spill
            if current in ("K1", "K2", "K3", "K3s", "K10") \
                    or current[:2] in ("K4", "K5", "K7", "K9") \
                    or "wide" in current or current.startswith("P1/P2"):
                expect("spill" not in line or " 0 bytes spill stores" in line,
                       f"ptxas: {current} spills: {line.strip()}")
            expect(current != "K5 dk/dv" or "registers" not in line
                   or f"Used {K5_DKV_REGISTERS} registers" in line,
                   f"ptxas: K5 dk/dv is not the kernel K5_SELF_MS was measured on "
                   f"({K5_DKV_REGISTERS} registers): {line.strip()}")
    print("  dynamic shared memory per block: "
          + ", ".join(f"{name} {n} bytes" for name, n in smem.items()))


def check_sass(lib_path) -> None:
    """The forward's four instances, K4's and K5's main kernels, K10, K7
    and the probes, disassembled from the built library, must load by TMA
    (UTMALDG), and K9's two instances by bulk copy (UBLKCP); all but K7
    and K9 multiply on wgmma: HGMMA (bf16), and for K10's int8 score and
    the int8 probe IGMMA; the forward and K10 store o by TMA (UTMASTG), K4
    adds dq by TMA reductions (UTMAREDG), K5's dq pass needs neither; K7
    and the probes use no global atomics (ATOM, RED; K9 takes its grid's
    ticket by one, on a counter, never on the data). K5's dk/dv kernel
    must have K5_DKV_INSTRUCTIONS instructions."""
    from hyvideo_prfl_torch.ops import _build

    kernels = {"flash_fwd_kernelILb0ELb1E": "K1", "flash_fwd_kernelILb1ELb1E": "K2",
               "flash_fwd_kernelILb0ELb0E": "K3", "flash_fwd_kernelILb1ELb0E": "K3s",
               "flash_bwd_merged_kernel": "K4", "flash_bwd_dkv_kernel": "K5 dk/dv",
               "flash_bwd_dq_kernel": "K5 dq", "flash_fwd_qk8_kernel": "K10",
               "rmsnorm_rope_bwd_kernelILb1E": "K7 rope", "rmsnorm_rope_bwd_kernelILb0E": "K7",
               "probe_kernelILb1E": "P int8", "probe_kernelILb0E": "P bf16",
               "ln_scale_shift_bwd_kernelI13__nv_bfloat16E": "K9 bf16-g",
               "ln_scale_shift_bwd_kernelIfE": "K9 fp32-g"}
    # the wgmma opcode each kernel needs
    gmma = {"K10": "IGMMA", "P int8": "IGMMA", "K7 rope": None, "K7": None,
            "K9 bf16-g": None, "K9 fp32-g": None}
    # the load: TMA tensor copies, but K9's rows are plain bulk copies
    load = {"K9 bf16-g": "UBLKCP", "K9 fp32-g": "UBLKCP"}
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {name: {} for name in kernels.values()}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((v for k, v in kernels.items() if k in line), None)
        elif current:
            if re.search(r"/\*[0-9a-f]{4,}\*/", line):  # an instruction, after its address
                counts[current]["all"] = counts[current].get("all", 0) + 1
            for op in ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "UTMAREDG", "UBLKCP"):
                if op in line:
                    counts[current][op] = counts[current].get(op, 0) + 1
            # the instruction's mnemonic, after its address and predicate
            words = [w for w in line.split("*/", 1)[-1].split() if not w.startswith("@")]
            if words and words[0].startswith(("ATOMG", "ATOM.", "RED.")):
                counts[current]["global atomic"] = counts[current].get("global atomic", 0) + 1
    for name, c in counts.items():
        print(f"  {name} SASS instruction counts: {c}")
        op, ld = gmma.get(name, "HGMMA"), load.get(name, "UTMALDG")
        expect(c.get(ld, 0) > 0 and (op is None or c.get(op, 0) > 0),
               f"{name}'s kernel lacks {ld} or {op}: {c}")
        expect(name not in ("K7 rope", "K7", "P int8", "P bf16") or not c.get("global atomic"),
               f"{name}'s kernel uses global atomics: {c}")
    expect(counts["K5 dk/dv"].get("all") == K5_DKV_INSTRUCTIONS,
           f"K5 dk/dv has {counts['K5 dk/dv'].get('all')} SASS instructions, not the "
           f"{K5_DKV_INSTRUCTIONS} of the kernel K5_SELF_MS was measured on")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "hyvideo_prfl_torch")):
        print("chip_smoke: hyvideo_prfl_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hyvideo_prfl_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    global CARD, T_START
    CARD = smi.stdout.strip().splitlines()[0]
    T_START = time.perf_counter()
    print(CARD)
    print_clocks("at the start")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; CPU: {len(os.sched_getaffinity(0))} cores "
          f"available, {torch.get_num_threads()} torch threads (the card-against-CPU "
          "checks' CPU halves run on them)")

    announce("phase 1: build")
    t0 = t_start = time.perf_counter()
    _build.lib()
    print(f"  kernels built in {_build.build_seconds:.2f} s "
          f"(loaded in {time.perf_counter() - t0:.2f} s)")
    lib = _build.lib()
    print_ptxas(_build.build_log, {"K1/K2/K3/K3s": lib.hyv_flash_fwd_smem(),
                                   "K4": lib.hyv_flash_bwd_merged_smem(),
                                   "K5 dq": lib.hyv_flash_bwd_dq_smem(),
                                   "K10": lib.hyv_flash_fwd_qk8_smem()})
    check_sass(_build.build())

    results = {}
    announce("phase 2: kernels against their plain versions at the 81-frame shapes")
    phase_kernels(results)
    announce("phase 2b: the shifted forward (K2, K3s) and the rope R against their plain "
             "versions")
    phase_shifted_kernels(results)
    announce("phase 3: whole-model check, card against CPU")
    phase_model()
    announce("phase 4: serving through the CLI path")
    serve_launches = phase_serve()
    announce("phase 5: backward kernels against their plain versions at the training shapes")
    route_launches = phase_bwd_kernels(results)
    announce("phase 5b: the key mask through K4 and K5")
    phase_masked_bwd()
    announce("phase 6: whole-model gradients, card against CPU")
    phase_grad_model()
    announce("phase 7: PRFL training through the CLI path")
    with tempfile.TemporaryDirectory() as root:
        train_launches = phase_train(root)
    # every kernel of the training path ran there (K5 in the step with
    # HYV_FLASH_MERGED_BWD=0; the JAX rule routes every full-width call to
    # K4 otherwise)
    expect(all(train_launches.get(k, 0) > 0 for k in KERNELS if k not in ("P1", "P2", "R")),
           f"a kernel of the training path never launched: {train_launches}")
    print(f"  serving launches {serve_launches}; training launches {train_launches}")
    announce("phase 8: the int8 probes P1 and P2")
    probe_launches = phase_probes(results)
    announce("phase 9: the un-normed DiT (qk_norm off): R, K2 and K3s")
    unnormed_launches = phase_unnormed()
    announce("phase 10: the 14B width (dim 5120, 40 heads) and bench.py's (1280, 10)")
    phase_wide(results)
    announce("phase 11: i2v and flf2v (the image cross-attention, i2v-14B/flf2v-14B served, "
          "one i2v PRFL step)")
    with tempfile.TemporaryDirectory() as root:
        i2v_launches = phase_i2v(results, root)

    announce("phase 12: PAVRM and the LRM handoff (t2v-14B ce, i2v-14B bt, card against CPU, "
          "the export to PRFL, checkpoints, EMA and resume)")
    with tempfile.TemporaryDirectory() as root:
        pavrm_launches = phase_pavrm(results, root)
    print(f"  PAVRM launches {pavrm_launches}")
    announce("phase 13: the VAE, umT5-XXL and CLIP ViT-H/14, and the CLIs through them")
    with tempfile.TemporaryDirectory() as root:
        encoder_launches = phase_encoders(results, root)
    print(f"  phase 13 launches {encoder_launches}")
    announce("phase 14: the dpm++ and euler solvers, TeaCache, LoRA, --transformer_path, "
             "--prompt_file and t2i-14B")
    with tempfile.TemporaryDirectory() as root:
        solver_launches = phase_solvers(results, root)
    print(f"  phase 14 launches {solver_launches}")
    announce("phase 15: the preprocess CLIs (a video to the latent cache, the captions), a "
             "PRFL step from that cache, and the whole CLIP")
    with tempfile.TemporaryDirectory() as root:
        preprocess_launches = phase_preprocess(results, root)
    print(f"  phase 15 launches {preprocess_launches}")
    announce("phase 16: multi-GPU on one card: optimizer-state offload (PAVRM bt at 81 "
             "frames), NCCL at world size 1 (FSDP2, Ulysses, sp_size 4), the kernels at the "
             "sp=4 shard shapes")
    with tempfile.TemporaryDirectory() as root:
        multi_launches = phase_multi(results, root)
    print(f"  phase 16 launches {multi_launches}")
    announce("phase 17: LoRA PRFL training, the ring on one card (r virtual ranks), the "
             "dots_all remat policy, the serving CLI's --ring_size clamp, the metric logger")
    with tempfile.TemporaryDirectory() as root:
        rest_launches = phase_rest(results, root)
    print(f"  phase 17 launches {rest_launches}")

    launches = {}
    for part in (serve_launches, train_launches, route_launches, probe_launches,
                 unnormed_launches, i2v_launches, pavrm_launches, encoder_launches,
                 solver_launches, preprocess_launches, multi_launches, rest_launches):
        _add(launches, part)
    expect(all(launches.get(k, 0) > 0 for k in KERNELS), f"a kernel never launched: {launches}")
    print_clocks("at the end")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s; {CARD}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
