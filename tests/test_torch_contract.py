"""Contracts of the PyTorch port that hold without a GPU:

- no tpu_asr_torch module imports JAX or flax (the machine with the card
  has neither);
- chip_smoke.py refuses to run without a CUDA device and never prints its
  success line there;
- on CPU tensors the kernel wrappers run their plain versions: a CPU forward
  launches nothing and builds nothing;
- EncoderConfig options outside the port's slice raise.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_asr.config import DecoderConfig, EncoderConfig, ModelConfig
from tpu_asr_torch.models.conformer import ConformerEncoder
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops import _kernels
from tpu_asr_torch.ops.cuda_attention import fused_relpos_attention_block
from tpu_asr_torch.ops.cuda_features import fused_logmel
from tpu_asr_torch.ops.cuda_subsampling import fused_subsampling

ROOT = Path(__file__).resolve().parent.parent
IMPORT_ALL = """
import importlib, pkgutil, sys
import tpu_asr_torch
names = [m.name for m in pkgutil.walk_packages(tpu_asr_torch.__path__,
                                               "tpu_asr_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **extra)
    env.pop("XLA_FLAGS", None)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", "import json" + IMPORT_ALL],
                          cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "tpu_asr_torch.models.transcribe" in out["modules"]
    assert "tpu_asr_torch.convert.from_jax" in out["modules"]
    assert out["bad"] == []


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_cpu_forward_launches_and_builds_nothing():
    cfg = ModelConfig(spec_augment=None,
                      encoder=EncoderConfig(n_layers=1, d_model=32, n_heads=2,
                                            conv_kernel_size=7),
                      decoder=DecoderConfig(feat_in=32, num_classes=16),
                      compute_dtype="float32")
    model = CTCModel(cfg).eval()
    sig = torch.randn(2, 8000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(sig, torch.tensor([8000, 5000]))
    assert out.log_probs.shape[:2] == out.greedy.shape
    assert torch.isfinite(out.log_probs).all()
    assert (fused_logmel.launches, fused_subsampling.launches,
            fused_relpos_attention_block.launches) == (0, 0, 0)
    assert _kernels.library.cache_info().currsize == 0
    assert _kernels.library_path().parent.parent == _kernels.BUILD_ROOT
    assert all(k.startswith(("encoder.", "decoder."))
               for k in model.state_dict())


@pytest.mark.parametrize("option", [
    {"subsampling": "dw_striding"}, {"subsampling_factor": 8},
    {"causal_downsampling": True}, {"att_context_size": (16, 16)},
    {"att_context_style": "chunked_limited"}, {"global_tokens": 1},
    {"reduction": "pooling", "reduction_factor": 2},
    {"conv_norm_type": "layer_norm"}, {"conv_context_size": "causal"},
    {"quantization": "int8"}, {"conv_backend": "pallas"},
    {"attention_backend": "triton"},
])
def test_options_outside_the_slice_raise(option):
    cfg = dataclasses.replace(EncoderConfig(n_layers=1, d_model=32,
                                            n_heads=2), **option)
    with pytest.raises(ValueError, match="does not implement"):
        ConformerEncoder(cfg)
