"""The serving kernels' `tpu_asr_torch::` custom ops (ops/_kernels.py
`custom_op`), on the CPU: torch.library.opcheck holds each op's fake
(shape) implementation to its CPU implementation (the plain version) at a
small model's shapes (B=2, T'=9, D=32) in fp32 and bf16; a CPU export with
the ops forced (`_kernels.cpu_ops`, the graph a card's export records)
names exactly the ops of its routes (fp; int8 with the conv kernel; the
fused eval FFN) and, saved and reloaded, gives the eager model's output
bit for bit. The CLI's --export_path and a fresh process's load:
tests/test_torch_export_cli.py."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import numpy as np
import pytest
import torch

import tpu_asr_torch.config as pconfig
from tpu_asr_torch.convert.export import export_inference, load_exported
from tpu_asr_torch.data.tokenizer import train_bpe
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops import _kernels
from tpu_asr_torch.ops import (cuda_attention, cuda_conv, cuda_features,
                               cuda_ffn, cuda_subsampling)

FEAT, D_MODEL, LAYERS, HEADS = 24, 32, 2, 4
BUCKETS = [(2, 0.2)]


def _cfg(tok, **enc):
    return pconfig.ModelConfig(
        preprocessor=pconfig.PreprocessorConfig(features=FEAT),
        spec_augment=None, encoder=pconfig.EncoderConfig(
            feat_in=FEAT, n_layers=LAYERS, d_model=D_MODEL, n_heads=HEADS,
            conv_kernel_size=7, **enc),
        decoder=pconfig.DecoderConfig(feat_in=D_MODEL,
                                      num_classes=tok.vocab_size),
        compute_dtype="float32")


@pytest.fixture(scope="module")
def tok():
    return train_bpe(["a quick brown fox", "jumps over lazy dogs"] * 3,
                     vocab_size=32)


def _signals(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(scale=0.1, size=n).astype(np.float32) for n in lens]


ROUTES = {  # encoder options -> the ops a CPU export with cpu_ops names
    "fp": ({}, {"logmel", "subsampling", "relpos_attention_block"}),
    "int8_conv": ({"quantization": "int8", "conv_backend": "pallas"},
                  {"logmel", "subsampling", "relpos_attention_block",
                   "ffn_sublayer_int8", "conv_module"}),
    "ffn_pallas": ({"ffn_backend": "pallas"},
                   {"logmel", "subsampling", "relpos_attention_block",
                    "ffn_sublayer"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cpu_ops_export_names_the_ops(tok, route, tmp_path):
    """With `_kernels.cpu_ops` a CPU export records each serving wrapper's
    custom op (the card's graph), the saved and reloaded program gives the
    eager model's output exactly (the ops' CPU implementations are the
    plain versions), and nothing is launched or built."""
    options, ops = ROUTES[route]
    torch.manual_seed(0)
    model = CTCModel(_cfg(tok, **options)).eval()
    with _kernels.cpu_ops():
        art = export_inference(model, tok, tmp_path / "ops.tasrx",
                               buckets=BUCKETS, device="cpu")
    ex = load_exported(art)
    prog = ex.buckets[0][1]
    names = {str(n.target).split(".")[1] for n in prog.graph.nodes
             if str(n.target).startswith(f"{_kernels.OPS}.")}
    assert names == ops
    sig = torch.from_numpy(np.stack([_signals((3200,))[0], np.pad(
        _signals((2000,))[0], (0, 1200))]))
    ln = torch.tensor([3200, 2000], dtype=torch.int32)
    with torch.no_grad():
        want = model(sig, ln)
        lp, enc_len = prog(sig, ln)
    torch.testing.assert_close(lp, want.log_probs, rtol=0, atol=0)
    torch.testing.assert_close(enc_len, want.encoded_len.to(enc_len.dtype))


def _op_args(dtype=torch.float32):
    """Each op's arguments at the small model's shapes (B=2, T'=9, D=32),
    CPU tensors from a seed."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    d, f, h, t, b = D_MODEL, 4 * D_MODEL, HEADS, 9, 2
    x = r(b, t, d).to(dtype)
    mask = torch.arange(t)[None] < torch.tensor([[t], [6]])
    from tpu_asr_torch.ops.features import dft_basis, mel_filterbank
    from tpu_asr_torch.ops.positions import rel_positional_encoding
    basis = torch.from_numpy(dft_basis(512, 400, "hann"))
    fb = torch.from_numpy(np.ascontiguousarray(
        mel_filterbank(16000, 512, FEAT, 0.0, None).T))
    ffn = (torch.ones(d) + 0.1 * r(d), 0.1 * r(d), r(f, d) / d ** 0.5,
           0.1 * r(f), r(d, f) / f ** 0.5, 0.1 * r(d))
    return {
        "logmel": (torch.randn(b, 3872, generator=g) * 0.1, 22, basis, fb,
                   160, 2.0 ** -24, 2.0, True),
        "subsampling": (r(b, 37, FEAT).to(dtype), r(8, 1, 3, 3),
                        0.1 * r(8), r(8, 8, 3, 3) / 9, 0.1 * r(8),
                        r(d, 8 * 6) / 7),
        "relpos_attention_block": (
            x, *(z for _ in range(3) for z in (r(d, d) / d ** 0.5,
                                               0.1 * r(d))),
            0.1 * r(h, d // h), 0.1 * r(h, d // h), r(d, d) / d ** 0.5,
            r(d, d) / d ** 0.5, rel_positional_encoding(t, d), mask, h,
            [-1, -1], None),
        "ffn_sublayer": (x, *ffn),
        "ffn_sublayer_int8": (x, *ffn),
        "conv_module": (x, mask, r(2 * d, d) / d ** 0.5, 0.1 * r(2 * d),
                        r(d, 7) / 3, 0.1 * r(d), 1 + 0.1 * r(d), 0.1 * r(d),
                        r(d, d) / d ** 0.5, 0.1 * r(d), [6, 0], "affine"),
    }


OPS = {"logmel": cuda_features.logmel_op,
       "subsampling": cuda_subsampling.subsampling_op,
       "relpos_attention_block": cuda_attention.attention_op,
       "ffn_sublayer": cuda_ffn.ffn_op,
       "ffn_sublayer_int8": cuda_ffn.ffn_int8_op,
       "conv_module": cuda_conv.conv_op}


@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck(name):
    """torch.library.opcheck (schema, fake tensor, dispatch) of each op on
    CPU tensors, fp32 and, where the op takes it, bf16; its CPU
    implementation is the plain version, the op is registered under
    `tpu_asr_torch::`."""
    op = getattr(torch.ops.tpu_asr_torch, name).default
    for dtype in ((torch.float32,) if name == "logmel"
                  else (torch.float32, torch.bfloat16)):
        args = _op_args(dtype)[name]
        torch.library.opcheck(op, args)
        assert torch.equal(OPS[name](*args), op(*args))
