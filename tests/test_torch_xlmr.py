"""The port's XLM-R text tower and the whole CLIP checkpoint
(hyvideo_prfl_torch/models/xlm_roberta.py, models/clip.XLMRobertaCLIP,
utils/encoders.{xlmr_from_jax, clip_full_from_jax, load_reference_clip})
against the JAX package on the CPU.

Weights are the port's seeded ``init_params``, mapped to the JAX trees by
``convert_encoders.xlmr_torch_to_flax``/``clip_full_torch_to_flax``; ids
are seeded with padding (pad id 1) at the end of some rows. Bounds: the
fp32 tower with its head within 1e-5 of max|JAX|; the converters bit for
bit; a whole-CLIP file read and written again byte-complete.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.models import clip as jclip
from hyvideo_prfl_tpu.models import xlm_roberta as jx
from hyvideo_prfl_tpu.utils import convert_encoders as ce
from hyvideo_prfl_torch.models import clip as tclip
from hyvideo_prfl_torch.models import xlm_roberta as tx
from hyvideo_prfl_torch.utils import encoders

torch.set_num_threads(2)

FP32 = 1e-5


def _state(module, prefix=""):
    return {prefix + k: v.float().numpy() for k, v in module.state_dict().items()}


def _tower(seed=0, out_dim=None, **kw):
    cfg = tx.tiny_xlmr(**kw)
    m = tx.init_params(tx.XLMRobertaWithHead(cfg, out_dim=out_dim),
                       torch.Generator().manual_seed(seed))
    return m, _state(m, "textual.")


def _ids(b=3, l=12, seed=1, vocab=100):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (b, l)).astype(np.int32)
    ids[1, 7:] = 1  # padded rows
    ids[2, 3:] = 1
    return ids


@pytest.mark.parametrize("out_dim", [None, 24])
def test_xlmr_with_head_matches_encode_with_head(out_dim):
    m, state = _tower(out_dim=out_dim)
    jcfg = jx.tiny_xlmr()
    tree = ce.xlmr_torch_to_flax(state, jcfg)
    ids = _ids()
    want = np.asarray(jx.encode_with_head(tree, jcfg, jnp.asarray(ids)))
    got = m.encode_with_head(torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (3, out_dim or 32)
    assert np.abs(got - want).max() <= FP32 * np.abs(want).max()
    tokens = np.asarray(jx.XLMRoberta(jcfg).apply({"params": tree["params"]}, jnp.asarray(ids)))
    got_tokens = m(torch.from_numpy(ids).long()).numpy()
    assert np.abs(got_tokens - tokens).max() <= FP32 * np.abs(tokens).max()


def test_mean_pool_matches_the_jax_one():
    x = np.random.default_rng(2).standard_normal((3, 12, 8)).astype(np.float32)
    ids = _ids()
    ids[0] = 1  # an all-pad row divides by max(count, 1)
    want = np.asarray(jx.mean_pool(jnp.asarray(x), jnp.asarray(ids)))
    got = tx.mean_pool(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _whole(seed=3, extras=True):
    """A seeded whole-CLIP state (tiny towers, ViT-H's 16 heads)."""
    vis = tclip.init_params(tclip.CLIPVisionTower(tclip.tiny_clip(num_heads=16)),
                            torch.Generator().manual_seed(seed))
    _, txt = _tower(seed + 1, num_heads=16)
    state = {**_state(vis, "visual."), **txt, "log_scale": np.float32(4.6052)}
    if extras:
        rng = np.random.default_rng(seed)
        state.update({"visual.post_norm.weight": rng.standard_normal(64).astype(np.float32),
                      "visual.post_norm.bias": rng.standard_normal(64).astype(np.float32),
                      "visual.head": rng.standard_normal((64, 32)).astype(np.float32)})
    return {k: np.asarray(v) for k, v in state.items()}


def _bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("extras", [True, False])
def test_converters_equal_the_jax_ones(extras):
    state = _whole(extras=extras)
    vcfg, tcfg = jclip.tiny_clip(num_heads=16), jx.tiny_xlmr(num_heads=16)
    tree = ce.clip_full_torch_to_flax(state, vcfg, tcfg)
    np_tree = jax.tree.map(np.asarray, tree)
    got = encoders.clip_full_from_jax(np_tree, tclip.tiny_clip(num_heads=16),
                                      tx.tiny_xlmr(num_heads=16))
    _bitwise(got, ce.clip_full_flax_to_torch(tree, vcfg, tcfg))
    _bitwise(got, state)
    txt = encoders.xlmr_from_jax(np_tree["textual"], tx.tiny_xlmr(num_heads=16))
    _bitwise(txt, ce.xlmr_flax_to_torch(tree["textual"], tcfg))


@pytest.mark.parametrize("extras", [True, False])
def test_load_reference_clip_round_trips_byte_complete(tmp_path, extras):
    state = _whole(extras=extras)
    encoders.save_reference(state, str(tmp_path / "clip.pth"))
    clip = encoders.load_reference_clip(str(tmp_path / "clip.pth"))
    assert clip.visual.cfg == tclip.tiny_clip(num_heads=16)
    assert clip.textual.cfg == tx.tiny_xlmr(num_heads=16)
    assert hasattr(clip.visual, "post_norm") == extras
    back = {k: v.numpy() for k, v in clip.state_dict().items()}
    encoders.save_reference(back, str(tmp_path / "again.pth"))
    a = torch.load(tmp_path / "clip.pth", weights_only=True)
    b = torch.load(tmp_path / "again.pth", weights_only=True)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # the image tower alone, as the serving CLI reads it, is the same tower
    vis = encoders.load_reference_clip_visual(str(tmp_path / "clip.pth"))
    img = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 28, 28, 3))
                           .astype(np.float32))
    assert torch.equal(vis(img), clip.visual(img))
    # and the text tower equals the JAX one through its head
    ids = _ids(seed=6)
    tree = ce.clip_full_torch_to_flax(state, jclip.tiny_clip(num_heads=16),
                                      jx.tiny_xlmr(num_heads=16))
    want = np.asarray(jx.encode_with_head(tree["textual"], jx.tiny_xlmr(num_heads=16),
                                          jnp.asarray(ids)))
    got = clip.textual.encode_with_head(torch.from_numpy(ids).long()).numpy()
    assert np.abs(got - want).max() <= FP32 * np.abs(want).max()


def test_xlmr_large_config_is_the_released_one():
    cfg = tx.xlm_roberta_large()
    assert (cfg.vocab_size, cfg.dim, cfg.num_heads, cfg.num_layers, cfg.max_seq_len,
            cfg.pad_id, cfg.eps) == (250002, 1024, 16, 24, 514, 1, 1e-5)
    assert cfg == tx.XLMRobertaConfig(**{k: getattr(jx.xlm_roberta_large(), k)
                                         for k in ("vocab_size", "max_seq_len", "type_size",
                                                   "pad_id", "dim", "num_heads", "num_layers",
                                                   "eps")})
    with torch.device("meta"):
        m = tx.XLMRobertaWithHead(cfg)
    d = cfg.dim
    block = 4 * (d * d + d) + (d * 4 * d + 4 * d) + (4 * d * d + d) + 4 * d
    tower = (cfg.vocab_size + cfg.max_seq_len + cfg.type_size) * d + 2 * d + 24 * block
    assert tower == 558_840_832  # XLM-R large
    assert sum(p.numel() for p in m.parameters()) == tower + 2 * d * d
