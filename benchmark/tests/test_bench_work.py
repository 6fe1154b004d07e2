"""The work counts: the kernels' bounds as the program's smoke harness
states them, and the shares they give."""

import pytest

from harness import devtrace, work

# chip_smoke.py's bounds (PERF.md's kernel table): K1 at the 81-frame CFG-2
# shape, K4 at batch 1, K3 over the 512 text keys at CFG 2
BOUNDS_MS = {"K1": 13.334, "K4": 16.668, "K3": 0.2084}


def test_attention_bounds_match_the_smoke_harness():
    assert work.attn_fwd(2, 12, 32760, 32760, 128).attn_fwd_s * 1e3 == pytest.approx(
        BOUNDS_MS["K1"], abs=1e-3)
    assert work.attn_bwd(1, 12, 32760, 32760, 128).attn_bwd_s * 1e3 == pytest.approx(
        BOUNDS_MS["K4"], abs=1e-3)
    assert work.attn_fwd(2, 12, 32760, 512, 128).attn_fwd_s * 1e3 == pytest.approx(
        BOUNDS_MS["K3"], abs=1e-3)


def test_gemm_bound_is_operations_or_bytes():
    big = work.gemm(32760, 1536, 8960)
    assert big.gemm_s == pytest.approx(2 * 32760 * 1536 * 8960 / 989e12)
    head = work.gemm(32760, 1536, 64, "fp32")  # the fp32 head: operations at 67 TFLOP/s
    assert head.gemm_s == pytest.approx(2 * 32760 * 1536 * 64 / 67e12)
    thin = work.gemm(1, 1536, 9216, "fp32")  # the time projection: bytes at 3.35 TB/s
    assert thin.gemm_s == pytest.approx(4 * (1536 + 1536 * 9216 + 9216) / 3.35e12)


CFG13 = dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30, freq_dim=256,
             text_dim=4096, in_dim=16, out_dim=16, patch_size=[1, 2, 2])


def test_step_work_counts_each_pass_once():
    fwd = work.forward(CFG13, 1, 32760, 512, 30)
    # 30 blocks of self (6.59 TFLOP) and text (0.10 TFLOP) attention
    assert fwd.flops == pytest.approx(283e12, rel=0.02)
    step = work.prfl_step(CFG13, 32760, 512, mid=19, lrm_layers=8)
    assert step.attn_fwd_s == pytest.approx(
        (19 + 2) * fwd.attn_fwd_s + work.forward(CFG13, 1, 32760, 512, 8, False).attn_fwd_s)
    # the backward: the policy twice and the LRM's 8 blocks, 10 units a call
    one = (work.attn_bwd(1, 12, 32760, 32760, 128).attn_bwd_s
           + work.attn_bwd(1, 12, 32760, 512, 128).attn_bwd_s)
    assert step.attn_bwd_s == pytest.approx((2 * 30 + 8) * one)
    serve = work.sample_step(CFG13, 32760, 512)
    assert serve.flops == pytest.approx(2 * fwd.flops, rel=1e-6)


def test_shares_of_a_trace():
    tr = devtrace.reduce([("flash_fwd_kernel<false, true>", True, 0, 100),
                          ("sm90_xmma_gemm_bf16", True, 100, 150),
                          ("elementwise", True, 200, 210),
                          ("aten::mm", False, 90, 205)], 220e-9)
    assert tr.group_s == {"K1": pytest.approx(1e-7), "GEMM": pytest.approx(5e-8),
                          "other": pytest.approx(1e-8)}
    assert tr.busy_s == pytest.approx(1.6e-7)
    assert dict(tr.idle_gaps)["aten::mm"] == pytest.approx(5e-8)
    assert tr.idle_share == pytest.approx(1 - 160 / 220)


def test_readers_read_the_shares_by_name():
    from harness import common

    tr = devtrace.reduce([("flash_fwd_kernel<false, true>", True, 0, 100),
                          ("sm90_xmma_gemm_bf16", True, 100, 150)], 200e-9)
    w = work.Work()
    w.attn_fwd_s, w.gemm_s, w.flops = 2.5e-8, 1e-8, 1e6
    r = common.Readings(steps=2, trace=tr, work=w, history=[])
    read = common.metric_reader
    assert read("attn_fwd_roofline.train")(r) == pytest.approx(50.0)
    assert read("gemm_roofline.sample")(r) == pytest.approx(40.0)
    assert read("attn_bwd_roofline.train")(r) is None  # no K4 or K5 in the trace
    assert read("idle_share.sample")(r) == pytest.approx(25.0)
    assert read("mfu.train")(r) == pytest.approx(100.0 * 2e6 / (200e-9 * work.PEAK["bf16"]))
    untraced = common.Readings(steps=2, trace=None, work=w, history=[])
    assert all(read(m)(untraced) is None for m in ("attn_fwd_roofline.sample", "idle_share.train",
                                                    "mfu.sample", "trainer_overhead_ms.train"))
