"""The profilers' groups (tpu_asr_torch/profile_forward.py GROUPS, read by
profile_forward and profile_train): every kernel of csrc/*.cu, as
torch.profiler names it, lands in the group of its own source, never in
another kernel's group or in the cuBLAS/cuDNN/ATen groups; the dk-128
attention kernels (conformer-XLarge) in groups of their own. And
`device_activity`'s per-call figures, on synthetic profiler events, stay
right when the profiler drops a call's events or a call's marker. The
profilers' model choices: profile_forward --model small|large|xlarge
(`model_config`), profile_train's ctc_large and ctc_xlarge (CTC alone on
those models), profile_kernels' dk-128 rows."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from tpu_asr_torch import profile_kernels, profile_train
from tpu_asr_torch.config import DistillationConfig
from tpu_asr_torch.profile_forward import (MARKER, MODELS, device_activity,
                                           group_of, model_config,
                                           short_symbol)

CSRC = Path(__file__).resolve().parents[1] / "tpu_asr_torch" / "csrc"
FAMILY = {
    "attention.cu": ("attention fwd", "attention proj", "attention bwd",
                     "attention fwd dk128", "attention bwd dk128"),
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


@pytest.mark.parametrize("name,group", [
    ("dq_mma_kernel<48, true>", "attention bwd (segments)"),
    ("dkv_mma_kernel<48, true>", "attention bwd (segments)"),
    ("dq_kernel<float, true>", "attention bwd (segments)"),
    ("core_mma_kernel<48, true>", "attention fwd (segments)"),
    ("dq_mma_kernel<48, false>", "attention bwd"),
    ("core_mma_kernel<48, false>", "attention fwd")])
def test_segment_mode_groups_by_itself(name, group):
    """The attention kernels' segment mode (kSeg = true), as the profiler
    names a template kernel, lands in a group of its own beside its
    kernel's."""
    assert group_of(f"void (anonymous namespace)::{name}(float const*)") \
        == group


@pytest.mark.parametrize("name,group", [
    ("core_mma_kernel<128, false>", "attention fwd dk128"),
    ("dq_mma_kernel<128, false>", "attention bwd dk128"),
    ("dkv_mma_kernel<128, false>", "attention bwd dk128"),
    ("core_kernel<float, false, 4>", "attention fwd dk128"),
    ("dq_kernel<float, false, 4>", "attention bwd dk128"),
    ("dkv_kernel<float, false, 4>", "attention bwd dk128"),
    ("core_kernel<float, false, 2>", "attention fwd"),
    ("dq_kernel<float, true, 4>", "attention bwd (segments)"),
    ("core_mma_kernel<128, true>", "attention fwd dk128 (segments)"),
    ("core_mma_kernel<64, false>", "attention fwd"),
    ("core_mma_kernel<64, false, true>", "attention fwd (window)"),
    ("dq_mma_kernel<48, true, true>", "attention bwd (segments, window)"),
    ("dkv_mma_kernel<64, true, false>", "attention bwd (segments)")])
def test_dk128_kernels_group_by_themselves(name, group):
    """The DKP-128 tensor-core kernels and the fp32 kernels' four-slot
    instantiations (dk 128) land in groups of their own; a segment mode
    (true as the second template argument) beside them."""
    assert group_of(f"void (anonymous namespace)::{name}(float const*)") \
        == group


@pytest.mark.parametrize("mangled,short", [
    ("_ZN12_GLOBAL__N_19dq_kernelIfLb0ELi4EEEvPKT_",
     "dq_kernel<float, false, 4>"),
    ("_ZN12_GLOBAL__N_111core_kernelIfLb1ELi2EEEvPKT_",
     "core_kernel<float, true, 2>"),
    ("_ZN12_GLOBAL__N_113dq_mma_kernelILi128ELb0EEEvPK",
     "dq_mma_kernel<128, false>"),
    ("_ZN12_GLOBAL__N_115core_mma_kernelILi64ELb0ELb1EEEvPK",
     "core_mma_kernel<64, false, true>"),
    ("_ZN12_GLOBAL__N_116layer_mma_kernelILi22ELi48EEEv",
     "layer_mma_kernel<22, 48>")])
def test_short_symbol_names_every_template_argument(mangled, short):
    assert short_symbol(mangled) == short


@pytest.mark.parametrize("name,d,layers,heads,k", [
    ("small", 176, 16, 4, 31), ("large", 512, 18, 8, 31),
    ("xlarge", 1024, 24, 8, 5)])
def test_model_choices(name, d, layers, heads, k):
    """profile_forward --model and profile_train's ctc_large / ctc_xlarge:
    bench.py's large_cfg and xl_cfg, trained with the CTC loss alone."""
    assert name in MODELS
    cfg = model_config(name)
    enc = cfg.encoder
    assert (enc.d_model, enc.n_layers, enc.n_heads, enc.conv_kernel_size,
            enc.d_ff) == (d, layers, heads, k, 4 * d)
    assert cfg.decoder.feat_in == d and cfg.decoder.num_classes == 128
    assert (cfg.spec_augment is None) == (name != "small")
    if name != "small":
        config = f"ctc_{name}"
        assert config in profile_train.CONFIGS
        assert profile_train.student_config(config) == cfg
        assert profile_train.distill_config(config) == DistillationConfig()
    with pytest.raises(ValueError):
        model_config("medium")


def test_profile_kernels_names_the_dk128_rows():
    rows = ("attention_dk128", "attention_dk128_bwd",
            "attention_heads_dk128", "attention_heads_dk128_bwd")
    assert set(rows) <= set(profile_kernels.KERNELS)
    assert profile_kernels.XL_D // profile_kernels.XL_HEADS == 128


def _calls(n):
    """Synthetic CUDA events of n marked calls, each: the marker, kernel a
    (1 ms) and kernel b twice (0.5 ms each), times in us."""
    ev = lambda start, dur, name: SimpleNamespace(
        device_type=DeviceType.CUDA, name=name,
        time_range=SimpleNamespace(start=start, end=start + dur))
    out, t = [], 0
    for _ in range(n):
        out += [ev(t, 2, f"void {MARKER}(long)"), ev(t + 10, 1000, "a"),
                ev(t + 1100, 500, "b"), ev(t + 1700, 500, "b")]
        t += 3000
    return out


@pytest.mark.parametrize("drop", ["none", "a call", "a marker",
                                  "the markers"])
def test_device_activity_survives_dropped_events(drop):
    events = _calls(5)
    if drop == "a call":
        events = events[4:]
    elif drop == "a marker":
        events = events[:8] + events[9:]
    elif drop == "the markers":
        events = [e for e in events if MARKER not in e.name]
    busy, launches, names = device_activity(
        SimpleNamespace(events=lambda: events), 5)
    assert (busy, launches) == (2.0, 3.0)
    assert names == {"a": (1.0, 1.0), "b": (1.0, 2.0)}
