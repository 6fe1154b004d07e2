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


FLASH_BWD = os.path.join(os.path.dirname(SCRIPT), os.pardir, "hyvideo_prfl_torch", "csrc",
                         "flash_bwd.cu")
DEVTRACE = os.path.join(os.path.dirname(SCRIPT), os.pardir, "benchmark", "harness",
                        "devtrace.py")


def _global_kernels(path):
    """The demangled name of every kernel a .cu file defines: each
    ``__global__`` function, and a ``template <bool ...>`` one at both
    arguments."""
    import re

    text = open(path).read()
    names = []
    for m in re.finditer(r"(template\s*<bool \w+>\s*)?__global__\s+void\s+"
                         r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", text):
        insts = ("<false>", "<true>") if m.group(1) else ("",)
        names += [f"void (anonymous namespace)::{m.group(2)}{i}(...)" for i in insts]
    return names


def test_every_flash_bwd_kernel_lands_in_k4_or_k5():
    # the benchmark's frozen groups file each kernel of the flash backward
    # under K4 or K5, never "other", so attn_bwd_roofline reads all of it
    import sys

    spec = importlib.util.spec_from_file_location("bench_devtrace", DEVTRACE)
    devtrace = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = devtrace  # its dataclass looks its module up
    spec.loader.exec_module(devtrace)
    groups = {name.split("::")[1].split("(")[0]: devtrace.group_of(name)
              for name in _global_kernels(FLASH_BWD)}
    # K4 launches the prologue's <false> instance and the merged kernel
    assert groups == {"flash_bwd_merged_kernel": "K4", "flash_bwd_prologue_kernel<false>": "K4",
                      "flash_bwd_prologue_kernel<true>": "K5", "flash_bwd_dkv_kernel": "K5",
                      "flash_bwd_dq_kernel": "K5"}
