"""K9's partition of a call (ops/stream.py k9_geometry), on the CPU.

The LayerNorm+modulate backward K9 (csrc/ln_scale_shift_bwd.cu) runs on a
persistent grid whose tiles, block runs and ds/dt partial slots the wrapper
computes and the kernel takes as given. These tests hold that geometry to
what the kernel relies on: every row in exactly one tile, contiguous runs
fixed by the shapes and the SM count, shared memory within the card's
227 KB, and the kernel's order of the ds/dt sums (lane partials across a
block's tiles, the row groups in order, the blocks in a fixed tree) giving
the plain backward's ds/dt.
"""

import numpy as np
import pytest
import torch

from hyvideo_prfl_torch.ops import stream as tstream

# (B, L, D, g bytes, SMs): the H100's 132 SMs at the model widths, and few
# SMs, so that block runs cross batch boundaries and span several
SHAPES = [
    (1, 3120, 1280, 2, 132),    # bench.py's shape
    (1, 32760, 1536, 2, 132),   # the training backward
    (1, 32760, 5120, 4, 132),   # PAVRM, the head's fp32 cotangent
    (2, 4685, 1536, 2, 132),
    (3, 37, 1920, 4, 7),
    (2, 1, 8192, 4, 132),       # L 1
    (5, 3, 128, 2, 4),          # L under one tile, runs across batches
    (2, 37, 256, 2, 5),
]


def _ids(shape):
    return "B{}-L{}-D{}-g{}-sm{}".format(*shape)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_k9_every_row_in_one_tile(shape):
    b, l, d, gb, sms = shape
    geo = tstream.k9_geometry(b, l, d, gb, sms)
    seen = np.zeros((b, l), np.int64)
    for tile in range(geo.tiles):
        bb, l0, rows = geo.rows(tile)
        assert 1 <= rows <= geo.T and l0 + rows <= l
        seen[bb, l0:l0 + rows] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_k9_runs_are_contiguous_and_fixed(shape):
    b, l, d, gb, sms = shape
    geo = tstream.k9_geometry(b, l, d, gb, sms)
    # a function of (B, L, D, g dtype, SMs) alone
    assert geo == tstream.k9_geometry(b, l, d, gb, sms)
    assert geo.grid == min(sms, geo.tiles)
    runs = [geo.run(i) for i in range(geo.grid)]
    assert [t for r in runs for t in r] == list(range(geo.tiles))
    assert all(len(r) >= 1 for r in runs)
    # the owner the kernel computes for a tile is the block whose run holds it
    for i, r in enumerate(runs):
        assert all(geo.owner(t) == i for t in r)
    # the partial slots i + b: one per (block, batch element) the runs
    # touch, all distinct and within the scratch the wrapper allocates
    pairs = {(i, geo.rows(t)[0]) for i, r in enumerate(runs) for t in r}
    slots = [i + bb for i, bb in pairs]
    assert len(set(slots)) == len(slots) and max(slots) < geo.slots
    for bb in range(b):
        assert {i for i, b2 in pairs if b2 == bb} == set(geo.blocks_of(bb))


@pytest.mark.parametrize("g_bytes", [2, 4])
def test_k9_geometry_fits_every_width(g_bytes):
    for d in range(128, tstream.MAX_DIM + 1, 128):
        geo = tstream.k9_geometry(1, 32760, d, g_bytes, 132)
        groups = d // 128
        assert geo.S in (1, 2, 4, 8) and geo.S * geo.T <= tstream.K9_WARPS
        assert -(-groups // geo.S) <= tstream.K9_MAX_GROUPS
        # the fewest warps a row
        assert geo.S == 1 or -(-groups // (geo.S // 2)) > tstream.K9_MAX_GROUPS
        assert geo.smem <= tstream.K9_SMEM_MAX and geo.ring % 16 == 0
        # header, s[b], and the row groups' [2, D] region when T > 1
        assert geo.ring == tstream.K9_HEADER + 4 * d + (8 * d if geo.T > 1 else 0)
        assert geo.stage_bytes == geo.T * d * (4 + g_bytes)
        # double buffering at least, and the in-flight target once reached
        assert 2 <= geo.stages <= tstream.K9_MAX_STAGES, (d, geo)
        assert (geo.stages - 1) * geo.stage_bytes < tstream.K9_IN_FLIGHT or geo.stages == 2
    # bench.py's width with the blocks' bf16 cotangent: 4 rows of 7.5 KB a
    # stage, 2 stages; the widest row with an fp32 cotangent: one 64 KB row
    geo = tstream.k9_geometry(1, 3120, 1280, 2, 132)
    assert (geo.S, geo.T, geo.stages, geo.grid) == (2, 4, 2, 132)
    geo = tstream.k9_geometry(1, 32760, 8192, 4, 132)
    assert (geo.S, geo.T, geo.stages) == (8, 1, 2)
    # narrow rows keep more, smaller stages loading
    assert tstream.k9_geometry(1, 32760, 128, 4, 132).stages == 6
    # L under a tile clamps T; the rows past it never exist
    assert tstream.k9_geometry(2, 3, 1280, 2, 132).T == 3


def _kernel_order_sums(geo, gyn, g):
    """ds, dt [B, D] summed as the kernel sums them: each row group's lane
    partials across the block's tiles of one batch element, the row groups
    in order into the block's slot, then per batch element lane j of a warp
    over the blocks first + j, first + j + 32, ..., and a shuffle tree."""
    f32 = np.float32
    part = np.zeros((geo.slots, 2, geo.d), f32)

    def flush(i, bb, acc):
        tot = acc[0]
        for r in range(1, geo.T):
            tot = (acc[r] + tot).astype(f32)
        part[i + bb] = tot

    for i in range(geo.grid):
        cur, acc = None, None
        for tile in geo.run(i):
            bb, l0, rows = geo.rows(tile)
            if bb != cur:
                if cur is not None:
                    flush(i, cur, acc)
                cur, acc = bb, np.zeros((geo.T, 2, geo.d), f32)
            for r in range(rows):
                acc[r, 0] += gyn[bb, l0 + r]
                acc[r, 1] += g[bb, l0 + r]
        flush(i, cur, acc)

    out = np.zeros((2, geo.b, geo.d), f32)
    for bb in range(geo.b):
        blocks = list(geo.blocks_of(bb))
        lanes = np.zeros((32, 2, geo.d), f32)
        for j in range(32):
            for i in blocks[j::32]:
                lanes[j] += part[i + bb]
        for off in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[np.arange(32) ^ off]).astype(f32)
        out[:, bb] = lanes[0]
    return out[0], out[1]


@pytest.mark.parametrize("shape", [
    (1, 3120, 1280, 2, 132), (2, 4685, 256, 2, 132), (3, 37, 1920, 4, 7),
    (5, 3, 128, 2, 4), (2, 1, 512, 4, 132), (2, 70, 5120, 2, 3)], ids=_ids)
def test_k9_kernel_order_sums_match_plain(shape):
    b, l, d, gb, sms = shape
    rng = np.random.RandomState(12)
    x = torch.from_numpy((rng.randn(b, l, d) * 0.5 + 0.3).astype(np.float32))
    s = torch.from_numpy((1.0 + 0.1 * rng.randn(b, d)).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, l, d).astype(np.float32))
    g = g.to({2: torch.bfloat16, 4: torch.float32}[gb])
    geo = tstream.k9_geometry(b, l, d, gb, sms)
    _, ds, dt = tstream.ln_scale_shift_bwd_plain(x, s, g)
    # the per-row terms the kernel adds: g * yn and g
    xc = x - x.mean(dim=-1, keepdim=True)
    yn = xc * torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + 1e-6)
    gf = g.float()
    kds, kdt = _kernel_order_sums(geo, (gf * yn).numpy(), gf.numpy())
    # fp32 sums in another order: 1e-5 of each output's max, as on the card
    for got, want in ((kds, ds), (kdt, dt)):
        want = want.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
