"""The profilers' groups (tpu_asr_torch/profile_forward.py GROUPS, read by
profile_forward and profile_train): every kernel of csrc/*.cu, as
torch.profiler names it, lands in the group of its own source, never in
another kernel's group or in the cuBLAS/cuDNN/ATen groups."""

import re
from pathlib import Path

import pytest

from tpu_asr_torch.profile_forward import group_of

CSRC = Path(__file__).resolve().parents[1] / "tpu_asr_torch" / "csrc"
FAMILY = {
    "attention.cu": ("attention fwd", "attention proj", "attention bwd"),
    "conv.cu": ("conv module",),
    "ctc.cu": ("ctc fwd", "ctc bwd"),
    "ffn.cu": ("ffn fwd", "ffn bwd"),
    "ffn_int8.cu": ("ffn int8",),
    "fm.cu": ("fm fwd", "fm bwd"),
    "layer.cu": ("conformer layer",),
    "logmel.cu": ("logmel",),
    "subsampling.cu": ("subsampling",),
}
KERNEL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def test_every_source_has_a_family():
    assert sorted(p.name for p in CSRC.glob("*.cu")) == sorted(FAMILY)


@pytest.mark.parametrize("source", sorted(FAMILY))
def test_kernels_land_in_their_sources_group(source):
    names = set(KERNEL.findall((CSRC / source).read_text()))
    assert names
    for name in sorted(names):
        for shown in (f"void (anonymous namespace)::{name}<__nv_bfloat16, "
                      f"(anonymous namespace)::Cfg<64, 64, 2> >(float const*)",
                      f"(anonymous namespace)::{name}(int, int)"):
            assert group_of(shown) in FAMILY[source], (name, group_of(shown))


def test_backward_groups_by_name():
    """The FFN backward's fixed-order sum and the attention backward's
    tensor-core kernels are charged to their own backward."""
    assert group_of("ffn_bwd_sum_kernel") == "ffn bwd"
    assert group_of("void (anonymous namespace)::sum_parts_kernel<float>"
                    "(float const*)") == "attention bwd"
    for name in ("dq_mma_kernel<48>", "dkv_mma_kernel<48>",
                 "wgrad_mma_kernel"):
        assert group_of(name) == "attention bwd"
