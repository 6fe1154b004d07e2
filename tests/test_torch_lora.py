"""LoRA in the port against the JAX package's: the three key formats read
and written, the merged tiny DiT against JAX's ``apply_lora``, a merge in
the reference layout then loaded against a merge after loading (bit for
bit), merge then int8 against ``apply_lora`` then ``quantize_params``;
``EvalPromptDataset``; and the serving CLI's LoRA flags,
``--transformer_path``, ``--prompt_file``/``--save_folder`` and t2i."""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.data import dataset as jds
from hyvideo_prfl_tpu.models import wan_dit as jdit
from hyvideo_prfl_tpu.ops import quant as jquant
from hyvideo_prfl_tpu.training import lora as jlora
from hyvideo_prfl_torch.data import dataset as tds
from hyvideo_prfl_torch.models import wan_dit as tdit
from hyvideo_prfl_torch.pipelines import pipeline as tpipe
from hyvideo_prfl_torch.training import lora as tlora
from hyvideo_prfl_torch.utils import checkpoint as tck
from hyvideo_prfl_torch.utils import safetensors_io

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=256, num_heads=2, ffn_dim=512, num_layers=2)
HEAD_DIM = TINY["dim"] // TINY["num_heads"]
FORMATS = ("transformer", "kohya", "diffusers")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _jax_lora(seed, rank=8, targets=("q", "k", "v", "o"), n_layers=2, dim=TINY["dim"]):
    """A JAX factor tree (numpy, the half rope layout) with non-zero A and B."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"lora": {attn: {m: {"A": rng.standard_normal((n_layers, dim, rank), f32) * f32(0.05),
                                "B": rng.standard_normal((n_layers, rank, dim), f32) * f32(0.05)}
                            for m in targets}
                     for attn in ("self_attn", "cross_attn")}}


def _np(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


@pytest.mark.parametrize("fmt", FORMATS)
def test_key_formats_match_jax(fmt):
    tree = _jax_lora(0)
    want_sd = _np(jlora.lora_state_dict(tree, fmt=fmt, head_dim=HEAD_DIM))
    got_sd = tlora.lora_state_dict(tlora.lora_from_jax(tree), fmt=fmt, head_dim=HEAD_DIM)
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v, err_msg=k)
    # read back in the half layout (head_dim), and in the reference layout
    for head_dim in (HEAD_DIM, None):
        want = jlora.lora_from_state_dict(want_sd, head_dim=head_dim)["lora"]
        got = tlora.lora_from_state_dict(want_sd, head_dim=head_dim)["lora"]
        assert set(got) == set(want) == {"self_attn", "cross_attn"}
        for attn, mods in want.items():
            assert set(got[attn]) == set(mods)
            for m, ab in mods.items():
                for f in ("A", "B"):
                    np.testing.assert_array_equal(got[attn][m][f].numpy(), np.asarray(ab[f]))
    # with head_dim the round trip is the identity; the reference layout
    # differs from it in the self-attention q/k B columns alone
    back = tlora.lora_from_state_dict(want_sd, head_dim=HEAD_DIM)["lora"]
    ref = tlora.lora_from_state_dict(want_sd)["lora"]
    for attn, mods in tree["lora"].items():
        for m, ab in mods.items():
            assert np.array_equal(back[attn][m]["B"].numpy(), ab["B"])
            moved = attn == "self_attn" and m in ("q", "k")
            assert np.array_equal(ref[attn][m]["B"].numpy(), ab["B"]) != moved


def _tiny_pair(seed=3):
    tree = tck.seeded_jax_tree(tdit.tiny_test(**TINY), seed=seed)
    cfg = tdit.tiny_test(**TINY, compute_dtype=torch.float32)
    model = tdit.WanModel(cfg)
    model.load_state_dict(tck.from_jax_params(tree, cfg))
    return tree, model.eval()


def _inputs(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 3, 8, 8, 16).astype(np.float32), np.float32([700.0, 300.0]),
            rng.randn(2, 16, 64).astype(np.float32))


@pytest.mark.parametrize("fmt", FORMATS + ("jax",))
def test_merged_dit_matches_jax_apply_lora(fmt):
    tree, model = _tiny_pair()
    lora = _jax_lora(1)
    scale = 0.7
    merged = jlora.apply_lora(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, lora),
                              scale=scale)
    x, t, ctx = _inputs()
    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32)
    want = np.asarray(jdit.WanModel(jcfg).apply(merged, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(ctx)))
    base = np.asarray(jdit.WanModel(jcfg).apply(tree, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(ctx)))
    if fmt == "jax":
        port_lora = tlora.lora_from_jax(lora)
    else:  # through the reference-format file contents, as the CLI reads them
        sd = _np(jlora.lora_state_dict(lora, fmt=fmt, head_dim=HEAD_DIM))
        port_lora = tlora.lora_from_state_dict(sd, head_dim=HEAD_DIM)
    tlora.merge_lora(model, port_lora, scale)
    # the merged weights: fp32 products of the same factors, summed in
    # another order: within a few ulps of the weights
    want_state = tck.from_jax_params(jax.tree.map(np.asarray, merged), model.cfg)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want_state[k], rtol=1e-6, atol=1e-6, msg=k)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert np.abs(want - base).max() > 1e-2 * np.abs(base).max()  # the LoRA moved the output
    # fp32 end to end: the model tests' 1e-4 of the scale
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["kohya", "transformer"])
def test_merge_in_the_reference_layout_then_load_is_bitwise(dtype, fmt):
    # permuting rows and adding elementwise commute: merge into the
    # reference state then load through from_reference_state, against load
    # then merge the half-layout factors into the model, in the storage dtype
    _, model = _tiny_pair()
    cfg = tdit.tiny_test(**TINY, compute_dtype=dtype)
    base = {k: v.to(dtype, copy=True) for k, v in model.state_dict().items()}
    sds = [_np(jlora.lora_state_dict(_jax_lora(s), fmt=fmt, head_dim=HEAD_DIM)) for s in (5, 6)]
    # the merge works in place: a copy of the reference state, in the storage dtype
    ref = {k: v.to(dtype, copy=True) for k, v in tck.to_reference_state(base, cfg).items()}
    for sd, scale in zip(sds, (1.0, 0.35)):
        tlora.merge_lora_state(ref, tlora.lora_from_state_dict(sd), scale)
    want = tdit.WanModel(cfg)
    want.load_state_dict(tck.from_reference_state(ref, cfg))
    got = tdit.WanModel(cfg)
    got.load_state_dict(base)
    for sd, scale in zip(sds, (1.0, 0.35)):
        tlora.merge_lora(got, tlora.lora_from_state_dict(sd, head_dim=HEAD_DIM), scale)
    moved = 0
    for k, v in got.state_dict().items():
        assert torch.equal(v, want.state_dict()[k]), k
        moved += not torch.equal(v, base[k])
    assert moved == 2 * 2 * 4  # two blocks' self and cross q/k/v/o


def test_merge_then_quantize_matches_jax():
    tree, model = _tiny_pair()
    lora = _jax_lora(2)
    merged = jax.tree.map(np.asarray, jlora.apply_lora(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, lora), scale=1.0))
    jcfg = jdit.tiny_test(**TINY, compute_dtype=jnp.float32, quant_dense="int8")
    shapes = jax.eval_shape(lambda: jdit.init_params(jcfg, jax.random.PRNGKey(0)))
    qtree = jax.tree.map(np.asarray, jquant.quantize_params(merged, shapes))
    tlora.merge_lora(model, tlora.lora_from_jax(lora), 1.0)
    qmodel = tck.quantize_model(model)
    want = tck.from_jax_params(qtree, qmodel.cfg)
    got = qmodel.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith(".weight_q"):
            # the merged fp32 weights differ by an ulp where XLA sums the
            # product in another order; a value on a rounding edge may land
            # on the neighbouring int8 step
            d = (got[k].int() - v.int()).abs()
            assert d.max() <= 1 and d.float().mean() < 1e-3, k
        else:
            torch.testing.assert_close(got[k].float(), v.float(), rtol=1e-5, atol=1e-7, msg=k)
    with pytest.raises(ValueError, match="before quantizing"):
        tlora.merge_lora(qmodel, tlora.lora_from_jax(lora), 1.0)


def test_merge_refuses_a_lora_of_more_blocks():
    _, model = _tiny_pair()
    with pytest.raises(KeyError, match="blocks.2"):
        tlora.merge_lora(model, tlora.lora_from_jax(_jax_lora(3, n_layers=3)))


# -- EvalPromptDataset --------------------------------------------------------


def test_eval_prompt_dataset_matches_jax(tmp_path):
    from PIL import Image

    txt = tmp_path / "p.txt"
    txt.write_text("a cat on a mat\n\n  a dog in fog  \nthird\n")
    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(7).integers(0, 255, (37, 61, 3), np.uint8)).save(img)
    jsn = tmp_path / "p.json"
    jsn.write_text(json.dumps([
        {"prompt": "first", "image_path": str(img), "seed": 3},
        {"caption": "second", "img_path": str(img)},
        {"short_caption": "third"}]))
    for path, kw in ((txt, {}), (jsn, dict(height=48, width=80))):
        want, got = jds.EvalPromptDataset(str(path), **kw), tds.EvalPromptDataset(str(path), **kw)
        assert got.items == want.items and len(got) == len(want) == 3
        for i in range(len(want)):
            a, b = got[i], want[i]
            assert a.keys() == b.keys()
            for k in a:
                if k == "image":
                    assert a[k].shape == (48, 80, 3) and np.array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k], k


# -- the serving CLI ------------------------------------------------------------


def _tiny_cli(monkeypatch, dtype=torch.float32):
    cli = _load_script("inference_torch")
    monkeypatch.setattr(cli, "dit_config_for_task",
                        lambda task, **kw: tdit.tiny_test(**TINY, compute_dtype=dtype, **kw))
    monkeypatch.setattr(cli, "latent_grid", lambda size, frames: ((frames - 1) // 4 + 1, 4, 4))
    return cli


def test_t2i_makes_one_frame():
    cli = _load_script("inference_torch")
    args = cli.args_init(["--task", "t2i-14B", "--size", "1024*1024"])
    assert args.frame_num == 1 and cli.pipeline_class(args.task) is tpipe.WanT2V
    assert cli.latent_grid(args.size, args.frame_num) == (1, 128, 128)
    assert cli.latent_grid("832*480", 1) == (1, 60, 104)
    with pytest.raises(SystemExit):
        cli.args_init(["--task", "t2i-14B", "--frame_num", "5"])


def test_t2i_writes_a_png(monkeypatch, tmp_path):
    from PIL import Image

    from hyvideo_prfl_torch.models import vae as tvae
    from hyvideo_prfl_torch.utils import encoders

    cli = _tiny_cli(monkeypatch)
    vae = tvae.init_params(tvae.WanVAE(tvae.tiny_vae(z_dim=16)), torch.Generator().manual_seed(9))
    encoders.save_reference({k: v.numpy() for k, v in vae.state_dict().items()},
                            str(tmp_path / "vae.pth"))
    assert cli.main(["--task", "t2i-14B", "--device", "cpu", "--sample_steps", "2",
                     "--vae_path", str(tmp_path / "vae.pth"),
                     "--save_file", str(tmp_path / "img.mp4")]) == 0
    img = np.asarray(Image.open(tmp_path / "img.png"))
    assert img.shape == (8, 8, 3) and img.dtype == np.uint8


def test_transformer_path_refuses_an_orbax_dir(tmp_path):
    cli = _load_script("inference_torch")
    orbax = tmp_path / "ckpt"
    (orbax / "d").mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    (orbax / "manifest.ocdbt").write_bytes(b"\0")
    args = cli.args_init(["--device", "cpu", "--transformer_path", str(orbax)])
    with pytest.raises(SystemExit, match="orbax"):
        cli.load_dit(args, tdit.tiny_test(**TINY), torch.device("cpu"))
    with pytest.raises(SystemExit, match="not a directory"):
        cli.load_transformer(str(tmp_path / "missing"), tdit.tiny_test(**TINY))


@pytest.mark.parametrize("quant", [False, True])
def test_cli_loads_the_transformer_then_merges_then_quantizes(monkeypatch, tmp_path, quant):
    cli = _tiny_cli(monkeypatch, torch.bfloat16)
    cfg = tdit.tiny_test(**TINY)
    tree = tck.seeded_jax_tree(cfg, seed=11)
    src = tck.save_reference_dir(tck.from_jax_params(tree, cfg), cfg, str(tmp_path / "out"),
                                 step=3)
    # one LoRA in kohya format as a .safetensors file, one in the
    # transformer format as a .pt state dict
    l1, l2 = _jax_lora(12), _jax_lora(13, targets=("q", "v"))
    safetensors_io.write_file(tlora.lora_state_dict(tlora.lora_from_jax(l1), "kohya", HEAD_DIM),
                              str(tmp_path / "a.safetensors"))
    torch.save(tlora.lora_state_dict(tlora.lora_from_jax(l2), "transformer", HEAD_DIM),
               str(tmp_path / "b.pt"))
    args = cli.args_init(["--device", "cpu", "--transformer_path", src,
                          "--lora_path", str(tmp_path / "a.safetensors"), "--lora_alpha", "0.5",
                          "--distill_lora_path", str(tmp_path / "b.pt"),
                          "--distill_lora_alpha", "2.0", *(["--quant", "int8"] * quant)])
    got = cli.build_pipeline(args).model.state_dict()
    want = tdit.WanModel(cfg)
    want.load_state_dict(tck.load_reference_dir(src, cfg))
    tlora.merge_lora(want, tlora.lora_from_jax(l1), 0.5)
    tlora.merge_lora(want, tlora.lora_from_jax(l2), 2.0)
    if quant:
        want = tck.quantize_model(want)
    want = want.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_prompt_file_with_save_folder(monkeypatch, tmp_path):
    cli = _tiny_cli(monkeypatch)
    (tmp_path / "p.txt").write_text("a red fox\na blue bird\n")
    rng = np.random.RandomState(8)
    np.save(tmp_path / "ctx.npy", rng.randn(1, 512, 64).astype(np.float32))
    common = ["--device", "cpu", "--frame_num", "5", "--sample_steps", "2", "--base_seed", "40",
              "--prompt_embeds", str(tmp_path / "ctx.npy"), "--save_file", "gen.mp4"]
    assert cli.main([*common, "--prompt_file", str(tmp_path / "p.txt"),
                     "--save_folder", str(tmp_path / "out")]) == 0
    assert sorted(os.listdir(tmp_path / "out")) == ["gen_000_latents.npy", "gen_001_latents.npy"]
    first, second = (np.load(tmp_path / "out" / f"gen_00{i}_latents.npy") for i in (0, 1))
    assert first.shape == second.shape == (1, 2, 4, 4, 16) and not np.array_equal(first, second)
    # the first record is the single request of its seed, bit for bit
    assert cli.main([*common, "--save_folder", str(tmp_path / "one")]) == 0
    assert os.listdir(tmp_path / "one") == ["gen_latents.npy"]
    assert np.array_equal(np.load(tmp_path / "one" / "gen_latents.npy"), first)
    # the second is the base seed + 1
    assert cli.main([*common, "--base_seed", "41", "--save_folder", str(tmp_path / "two")]) == 0
    assert np.array_equal(np.load(tmp_path / "two" / "gen_latents.npy"), second)
