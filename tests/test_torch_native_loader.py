"""The port's read-ahead ring (hyvideo_prfl_torch/data/native_loader.py over
csrc/latent_loader.cpp, built here with the host C++ compiler) and the
batch iterator's read-ahead thread (data/loader.py), against numpy and the
JAX package's BatchIterator on the CPU. Arrays must come back bit for bit,
in submission order; batches equal the inline stream's and the JAX
iterator's.
"""

import json
import os
import threading

import numpy as np
import pytest

from hyvideo_prfl_tpu.data import loader as jloader
from hyvideo_prfl_tpu.data.dataset import LatentCacheDataset as JDataset
from hyvideo_prfl_torch.data import loader as tloader
from hyvideo_prfl_torch.data import native_loader as nl
from hyvideo_prfl_torch.data.dataset import LatentCacheDataset


@pytest.fixture
def npy_files(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((1, 16, 3, 8, 8)).astype(np.float32),
              rng.standard_normal((20, 64)).astype(np.float16),
              (rng.random(7) * 100).astype(np.int64),
              rng.integers(0, 256, (4, 5, 3), dtype=np.uint8),
              rng.standard_normal((5, 5)),  # float64
              np.float32(3.5)]  # a scalar comes back as shape (1,)
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"a{i}.npy"))
        np.save(paths[-1], a)
    return paths, arrays


def test_the_ring_builds_from_the_port_source():
    path = nl.build()
    assert path.parent == nl.BUILD_DIR and path.name.startswith("liblatentloader_")
    assert nl.SOURCE.parent.name == "csrc" and "hyvideo_prfl_torch" in str(nl.SOURCE)
    assert nl.build() == path  # keyed by the source: built once
    assert nl.lib() is nl.lib()


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want.reshape(got.shape)) and got.size == want.size


@pytest.mark.parametrize("threads", [1, 4])
def test_read_many_equals_np_load_in_order(npy_files, threads):
    paths, arrays = npy_files
    stream = nl.NativeStream(slots=3, threads=threads)
    for _ in range(3):  # the stream is reused across calls
        order = [5, 0, 3, 1, 4, 2, 0]
        for got, i in zip(stream.read_many([paths[i] for i in order]), order):
            _same(got, arrays[i])
    assert sorted({a.dtype for a in stream.read_many(paths)}, key=str) == sorted(
        {np.dtype(t) for t in nl._DTYPES.values()}, key=str)
    stream.close()
    with pytest.raises(ValueError):
        stream.read_many(paths)


def test_prefetcher_equals_np_load(npy_files, tmp_path):
    paths, arrays = npy_files
    pf = nl.NativePrefetcher(paths, slots=2, threads=3)
    got = list(pf)
    assert len(got) == len(arrays)
    for g, a in zip(got, arrays):
        _same(g, a)
    pf.close()
    rng = np.random.default_rng(1)
    many = [rng.standard_normal((32, 64)).astype(np.float32) for _ in range(40)]
    for i, a in enumerate(many):
        np.save(tmp_path / f"s{i}.npy", a)
    got = list(nl.NativePrefetcher([str(tmp_path / f"s{i}.npy") for i in range(40)], 4, 4))
    assert all(np.array_equal(g, a) for g, a in zip(got, many)) and len(got) == 40


@pytest.mark.parametrize("fault", ["missing", "truncated", "bad magic"])
def test_a_bad_file_raises_and_the_stream_goes_on(npy_files, tmp_path, fault):
    paths, arrays = npy_files
    bad = str(tmp_path / "bad.npy")
    if fault == "truncated":
        with open(paths[0], "rb") as f:
            data = f.read()
        with open(bad, "wb") as f:
            f.write(data[:len(data) - 100])
    elif fault == "bad magic":
        with open(bad, "wb") as f:
            f.write(b"x" * 200)
    stream = nl.NativeStream()
    with pytest.raises(IOError):
        stream.read_many([paths[0], bad, paths[1]])
    # every submission of the failed call was collected: the next call's
    # arrays are its own
    _same(stream.read_many([paths[3]])[0], arrays[3])
    pf = nl.NativePrefetcher([paths[0], bad])
    it = iter(pf)
    _same(next(it), arrays[0])
    with pytest.raises(IOError):
        next(it)


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(nl, "SOURCE", src)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        nl.build()
    assert not any((tmp_path / "build").iterdir())  # no half-written library left


def test_builds_at_once_load_one_whole_library(monkeypatch, tmp_path):
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    out, errors = [], []

    def one():
        try:
            out.append(nl.build())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(out)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [out[0].name]


def _cache(root, n=5):
    """n refl samples (latents, two captions, cond, clip) and null texts."""
    rng = np.random.default_rng(2)
    os.makedirs(root / "null" / "wanx")
    for name in ("null", "uncond"):
        np.save(root / "null" / "wanx" / f"{name}.npy", rng.standard_normal((1, 3, 8)))
    metas = []
    for i in range(n):
        p = {k: str(root / f"{i}_{k}.npy") for k in ("lat", "short", "long", "cond", "clip")}
        t = 2 + i % 2  # two latent shapes
        np.save(p["lat"], rng.standard_normal((1, 4, t, 2, 2)).astype(np.float32))
        np.save(p["cond"], rng.standard_normal((1, 4, t, 2, 2)).astype(np.float32))
        np.save(p["short"], rng.standard_normal((1, 3, 8)).astype(np.float32))
        np.save(p["long"], rng.standard_normal((1, 5, 8)).astype(np.float32))
        np.save(p["clip"], rng.standard_normal((1, 6, 8)).astype(np.float32))
        meta = dict(vae_latent_path=p["lat"], textshort_path=p["short"],
                    textlong_path=p["long"], f1_black_path=p["cond"], imgclip_path=p["clip"],
                    short_caption=f"short {i}", long_caption=f"long {i}")
        metas.append(str(root / f"{i}_meta.json"))
        with open(metas[-1], "w") as f:
            json.dump(meta, f)
    with open(root / "list.txt", "w") as f:
        f.write("\n".join(metas) + "\n")
    return dict(meta_file_list=[str(root / "list.txt")], uncond_prob=[0.3, 0.0], text_len=6,
                null_dir=str(root / "null"), is_i2v=True, seed=3)


def _take(it, n):
    return [next(it) for _ in range(n)]


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], list):
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("shuffle", [False, True])
def test_read_ahead_batches_equal_the_inline_and_jax_ones(tmp_path, shuffle):
    kw = _cache(tmp_path)

    def port(prefetch, skip=0):
        ds = LatentCacheDataset(**kw)
        return tloader.BatchIterator(ds, tloader.BlockDistributedSampler(len(ds), shuffle, 5),
                                     batch_size=2, skip_batches=skip, prefetch=prefetch)

    got = _take(iter(port(2)), 6)
    inline = _take(iter(port(0)), 6)
    jds = JDataset(**kw)
    jit = jloader.BatchIterator(jds, jloader.BlockDistributedSampler(len(jds), shuffle=shuffle,
                                                                      seed=5),
                                batch_size=2, prefetch=2, group_by_shape=True)
    want = _take(iter(jit), 6)
    for g, i, w in zip(got, inline, want):
        _equal(g, i)
        _equal(g, w)
    # a resumed stream: the first 4 batches replayed in the worker
    for g, r in zip(got[4:], _take(iter(port(2, skip=4)), 2)):
        _equal(g, r)


def test_a_worker_exception_reaches_the_consumer(tmp_path):
    kw = _cache(tmp_path, n=2)

    class Broken(LatentCacheDataset):
        def __getitem__(self, idx):
            if idx == 1:
                raise KeyError("sample 1 is broken")
            return super().__getitem__(idx)

    ds = Broken(**kw)
    it = iter(tloader.BatchIterator(ds, tloader.BlockDistributedSampler(len(ds)), prefetch=2))
    assert next(it)["latents"].shape == (1, 2, 2, 2, 4)
    with pytest.raises(KeyError, match="sample 1 is broken"):
        next(it)


def test_latent_tokens_equals_the_jax_one():
    for shape in [(21, 60, 104, 16), (1, 30, 52, 16), (5, 3, 5, 4)]:
        assert tloader.latent_tokens(shape) == jloader.latent_tokens(shape)
    assert tloader.latent_tokens((21, 60, 104, 16)) == 32_760
