"""The profile script's kernel groups (scripts/profile_torch_step.py).

PERF.md's tables of device time by kernel come from ``group_of``, which maps
the kernel names torch.profiler reports (demangled C++ names) to the
kernels K1-K10, R, GEMM and other. A kernel renamed in csrc/ without its
fragment here would land in "other" silently.
"""

import importlib.util
import os

import pytest

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "profile_torch_step.py")


@pytest.fixture(scope="module")
def profile():
    spec = importlib.util.spec_from_file_location("profile_torch_step", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_fwd_kernel<false, true>(CUtensorMap_st, float*)", "K1"),
    ("void (anonymous namespace)::flash_fwd_kernel<true, true>(CUtensorMap_st, float*)", "K2"),
    ("void (anonymous namespace)::flash_fwd_kernel<false, false>(CUtensorMap_st, float*)",
     "K3"),
    ("void (anonymous namespace)::flash_fwd_kernel<true, false>(CUtensorMap_st, float*)",
     "K3s"),
    ("void (anonymous namespace)::flash_bwd_merged_kernel(CUtensorMap_st, MergedArgs)", "K4"),
    ("void (anonymous namespace)::flash_bwd_prologue_kernel(PrologueArgs)", "K4"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<false>(float*)", "K5"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel(float*)", "K5"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel(BwdArgs)", "K5"),
    ("void (anonymous namespace)::rmsnorm_rope_kernel<6, true>(float*)", "K6"),
    ("void (anonymous namespace)::rmsnorm_rope_bwd_kernel<6, true>(float*)", "K7"),
    ("void (anonymous namespace)::rmsnorm_rope_kernel<8, 4, false, true>(float*)", "K6"),
    ("void (anonymous namespace)::rmsnorm_rope_bwd_kernel<1, 6, true, false>(float*)", "K7"),
    ("void (anonymous namespace)::ln_scale_shift_kernel<8, 8, false, float>(float*)", "K8"),
    ("void (anonymous namespace)::ln_scale_shift_bwd_kernel<1, 12, true, float>(float*)", "K9"),
    ("void (anonymous namespace)::ln_scale_shift_kernel<12, __nv_bfloat16>(float*)", "K8"),
    ("void (anonymous namespace)::ln_scale_shift_bwd_kernel<12, float>(float*)", "K9"),
    ("void (anonymous namespace)::flash_fwd_qk8_kernel(signed char const*)", "K10"),
    ("void (anonymous namespace)::rope_kernel<float>(float const*)", "R"),
    # the symbols of K4/K5 (one dk/dv body, two kernels; the prologue's
    # instances) and of K10 on TMA and wgmma
    ("void (anonymous namespace)::flash_bwd_merged_kernel(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, KvArgs)", "K4"),
    ("void (anonymous namespace)::flash_bwd_prologue_kernel<false>(PrologueArgs)", "K4"),
    ("void (anonymous namespace)::flash_bwd_prologue_kernel<true>(PrologueArgs)", "K5"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, KvArgs)", "K5"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, DqArgs)", "K5"),
    ("void (anonymous namespace)::flash_fwd_qk8_kernel(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, float*, int, int, int, int, int)", "K10"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "GEMM"),
    ("void at::native::vectorized_elementwise_kernel<4, float>(int)", "other"),
])
def test_profile_groups_name_each_kernel(profile, name, group):
    assert profile.group_of(name) == group
