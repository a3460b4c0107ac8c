"""`.nemo` teacher import: the port's counterpart of
tpu_asr/convert/nemo_import.py (reference: EncDecCTCModelBPE.from_pretrained
and the release_nemoAPI unpack, asr_train.py:165-176).

A `.nemo` is a tar (gzipped or not; NGC's has its members under "./") of
`model_config.yaml`, `model_weights.ckpt` and artifacts such as
`<uniq>_tokenizer.model`. The port's CTCModel has NeMo's parameter names,
so the weights load as they are: `load_nemo_checkpoint` reads the config
with the port's YAML reader (utils/yaml_subset.py), the weights with
`torch.load(weights_only=True)`, keeps the `encoder.*` and `decoder.*`
entries (NeMo's preprocessor buffers are rebuilt by the featurizer) and
loads them into a CTCModel strictly.
"""

from __future__ import annotations

import tarfile
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from tpu_asr_torch.config import (DecoderConfig, EncoderConfig, ModelConfig,
                                  PreprocessorConfig, SpecAugmentConfig)


def extract_nemo(nemo_path, out_dir=None) -> Dict[str, Path]:
    """Extract a .nemo tar(.gz). Returns {'config', 'weights', 'tokenizer'
    (if present), 'vocab' (if present), 'dir'}."""
    nemo_path = Path(nemo_path)
    out_dir = Path(out_dir) if out_dir else Path(
        tempfile.mkdtemp(prefix="nemo_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        tar = tarfile.open(nemo_path, "r:gz")
    except tarfile.ReadError:
        tar = tarfile.open(nemo_path, "r:")
    with tar:
        tar.extractall(out_dir, filter="data")
    found: Dict[str, Path] = {"dir": out_dir}
    for p in sorted(out_dir.rglob("*")):
        name = p.name
        if name.endswith("model_config.yaml"):
            found["config"] = p
        elif name.endswith("model_weights.ckpt"):
            found["weights"] = p
        elif name.endswith("tokenizer.model"):
            found.setdefault("tokenizer", p)
        elif name.endswith(".vocab"):
            found.setdefault("vocab", p)
    if "config" not in found or "weights" not in found:
        raise FileNotFoundError(
            f"{nemo_path}: missing model_config.yaml / model_weights.ckpt")
    return found


def nemo_config_to_model_config(cfg: Dict[str, Any]) -> ModelConfig:
    """NeMo OmegaConf dict (model_config.yaml) -> ModelConfig."""
    pre = cfg.get("preprocessor", {})
    enc = cfg.get("encoder", {})
    dec = cfg.get("decoder", {})
    spec = cfg.get("spec_augment") or {}

    def g(d, k, default):
        v = d.get(k, default)
        return default if v is None else v

    preprocessor = PreprocessorConfig(
        sample_rate=g(pre, "sample_rate", 16000),
        window_size=g(pre, "window_size", 0.025),
        window_stride=g(pre, "window_stride", 0.01),
        window=g(pre, "window", "hann"),
        features=g(pre, "features", 80),
        n_fft=g(pre, "n_fft", 512),
        dither=g(pre, "dither", 1.0e-5),
        pad_to=g(pre, "pad_to", 0),
        normalize=g(pre, "normalize", "per_feature"),
        preemph=g(pre, "preemph", 0.97))
    encoder = EncoderConfig(
        feat_in=g(enc, "feat_in", preprocessor.features),
        n_layers=g(enc, "n_layers", 16),
        d_model=g(enc, "d_model", 176),
        n_heads=g(enc, "n_heads", 4),
        ff_expansion_factor=g(enc, "ff_expansion_factor", 4),
        subsampling=g(enc, "subsampling", "striding"),
        subsampling_factor=g(enc, "subsampling_factor", 4),
        subsampling_conv_channels=g(enc, "subsampling_conv_channels", -1),
        self_attention_model=g(enc, "self_attention_model", "rel_pos"),
        xscaling=g(enc, "xscaling", True),
        untie_biases=g(enc, "untie_biases", True),
        pos_emb_max_len=g(enc, "pos_emb_max_len", 5000),
        conv_kernel_size=g(enc, "conv_kernel_size", 31),
        conv_norm_type=g(enc, "conv_norm_type", "batch_norm"),
        dropout=g(enc, "dropout", 0.1),
        dropout_pre_encoder=g(enc, "dropout_pre_encoder", 0.1),
        dropout_emb=g(enc, "dropout_emb", 0.0),
        dropout_att=g(enc, "dropout_att", 0.1))
    num_classes = g(dec, "num_classes", 128)
    if num_classes < 0:
        num_classes = len(dec.get("vocabulary") or [])
    decoder = DecoderConfig(feat_in=g(dec, "feat_in", encoder.d_model),
                            num_classes=num_classes)
    spec_cfg = None
    if spec:
        spec_cfg = SpecAugmentConfig(
            freq_masks=g(spec, "freq_masks", 2),
            time_masks=g(spec, "time_masks", 10),
            freq_width=g(spec, "freq_width", 27),
            time_width=g(spec, "time_width", 0.05))
    return ModelConfig(sample_rate=preprocessor.sample_rate,
                       preprocessor=preprocessor, spec_augment=spec_cfg,
                       encoder=encoder, decoder=decoder)


def read_yaml(path) -> Any:
    from tpu_asr_torch.utils.yaml_subset import safe_load
    with open(path, encoding="utf-8") as f:
        return safe_load(f)


def nemo_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A NeMo state_dict (or a Lightning checkpoint holding one) -> the
    CTCModel's entries: `encoder.*` and `decoder.*`."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items()
            if k.startswith(("encoder.", "decoder."))}


def load_nemo_checkpoint(nemo_path, out_dir=None
                         ) -> Tuple[ModelConfig, Dict[str, torch.Tensor],
                                    Optional[Path]]:
    """.nemo -> (ModelConfig, the CTCModel's state_dict, tokenizer path or
    None). The state_dict is checked by a strict load into CTCModel(cfg)."""
    from tpu_asr_torch.models.ctc_model import CTCModel

    found = extract_nemo(nemo_path, out_dir)
    cfg = nemo_config_to_model_config(read_yaml(found["config"]))
    sd = nemo_state_dict(torch.load(found["weights"], map_location="cpu",
                                    weights_only=True))
    model = CTCModel(cfg)
    model.load_state_dict(sd, strict=True)
    return cfg, model.state_dict(), found.get("tokenizer")
