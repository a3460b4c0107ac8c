"""The inference CLI's --export_path (tpu_asr_torch/cli/common.py
`run_inference`), on the CPU: it writes the restored student's artifact
(convert/export.py) and exits before evaluation; `load_exported` of it, in
this process and in a fresh one that imports only the port's loader (no
jax, jaxlib, flax or tpu_asr module), transcribes as the Transcriber does
with the checkpoint's weights. Texts equal."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tests.test_torch_export_ops import (D_MODEL, FEAT, HEADS, LAYERS,
                                         _signals, tok)  # noqa: F401
from tpu_asr_torch.convert.export import load_exported
from tpu_asr_torch.models.ctc_model import CTCModel

ROOT = Path(__file__).resolve().parent.parent
LOAD_FRESH = """
import json, sys
import numpy as np
from tpu_asr_torch.convert.export import load_exported
ex = load_exported(sys.argv[1])
rng = np.random.default_rng(0)
sigs = [rng.normal(scale=0.1, size=n).astype(np.float32)
        for n in (1400, 4700, 2500)]
texts = ex.transcribe(sigs)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_asr"))
print(json.dumps({"texts": texts, "bad": bad}))
"""


def test_cli_export_path_writes_a_loadable_artifact(tok, tmp_path, capsys):
    """asr_inference --export_path on a student checkpoint writes the
    artifact and exits before evaluation; load_exported transcribes with
    it as the Transcriber does with the checkpoint's weights, here and in
    a fresh process that loads nothing of JAX."""
    from tpu_asr_torch.cli import asr_inference
    from tpu_asr_torch.convert.nemo_import import nemo_config_to_model_config
    from tpu_asr_torch.models.transcribe import Transcriber

    cfg = {"preprocessor": {"features": FEAT},
           "encoder": {"feat_in": FEAT, "n_layers": LAYERS,
                       "d_model": D_MODEL, "n_heads": HEADS,
                       "conv_kernel_size": 7},
           "decoder": {"feat_in": D_MODEL, "num_classes": tok.vocab_size}}
    (tmp_path / "tiny.yaml").write_text(json.dumps(cfg))
    tok.save(tmp_path / "tok.model")
    torch.manual_seed(3)
    model = CTCModel(nemo_config_to_model_config(cfg)).eval()
    torch.save(model.state_dict(), tmp_path / "student")
    out = tmp_path / "served" / "tiny.tasrx"
    res = asr_inference.main([
        "--ckpt_path", str(tmp_path / "student"), "--test_manifest",
        str(tmp_path / "none.jsonl"), "--config", str(tmp_path / "tiny.yaml"),
        "--tokenizer", str(tmp_path / "tok.model"), "--is_teacher", "true",
        "--output_dir", str(tmp_path), "--platform", "cpu",
        "--export_path", str(out), "--export_buckets", "2:0.4"])
    assert res == {}
    assert f"serialized inference artifact: {out}" in capsys.readouterr().out
    ex = load_exported(out)
    assert [(e["batch_size"], e["seconds"]) for e, _ in ex.buckets] == \
        [(2, 0.4)]
    sigs = _signals((1400, 4700, 2500))
    want = Transcriber(model, tok, batch_size=2, bucket_seconds=0.4,
                       device="cpu").transcribe(sigs)
    assert ex.transcribe(sigs) == want

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", LOAD_FRESH, str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300, check=True)
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    assert fresh["bad"] == []
    assert fresh["texts"] == want
