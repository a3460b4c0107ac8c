"""The port's CLI plumbing: the counterpart of tpu_asr/cli/common.py, with
its flag surface and defaults (reference asr_train.py:1380-1585,
asr_inference.py:205-305, asr_train_diffm.py:1636-1647). The entry points
beside this module (asr_train.py, ..., asr_inference_diffm.py) are thin
wrappers, runnable with `python -m tpu_asr_torch.cli.<name>`.

- Device: `--platform ''` (the default) runs on the CUDA card and exits
  with an error when there is none; `--platform cpu` runs on the CPU (as
  the tests do). Nothing falls back to the CPU on its own.
- Data parallelism (the train and inference CLIs): `--gpus N` (-1: every
  visible card) with N > 1 starts N ranks (parallel/launch.py), one a card,
  joined over NCCL; `--platform cpu --gpus N` or `--host_devices N` starts
  N ranks on the CPU over gloo (JAX's virtual devices). Under a launcher
  that set WORLD_SIZE (torchrun) the process joins that group instead.
  `--batch_size` is the GLOBAL batch: each rank takes its block of every
  batch, and the run takes the steps one rank takes
  (tpu_asr_torch/train/loop.py); an evaluation sums its counts over the
  ranks. Rank 0 alone writes the tokenizer sidecar, metrics and
  checkpoints, and prints the results. `--gpus` above the visible cards
  exits with a message.
- `--steps_per_dispatch K` runs K same-shape batches as one multi-step;
  `--cache_teacher` / `--cache_teacher_all` keep the frozen teacher's last
  layer / every layer a utterance after its first epoch, in RAM or, with
  `--cache_teacher_dir`, one file a utterance (TrainConfig's fields of
  those names; train/loop.py).
- `--teacher_nemo PATH` imports a local `.nemo` (convert/nemo_import.py);
  without it the teacher is randomly initialized, from `--config` (read
  with the port's YAML reader) and a fallback BPE tokenizer trained on the
  manifests' texts, saved as `checkpoints/tokenizer.model`, which inference
  prefers to training another.
- Manifests: `--train_manifest / --val_manifest / --test_manifest`, the
  last two also as "name=path,name=path"; without any of them each split
  is built from the Hugging Face dataset `--data_script_path`
  (`prepare_manifests`), which needs the `datasets` package.
- `--teacher_int8` runs the frozen teacher's FFN sublayers in int8.
- `--ckpt_path` of asr_inference takes `checkpoints/last` (the whole train
  state) or a student export (`checkpoints/student`, the student's
  weights only, which serves a run without flow matching, whose decoder
  input is the student's own encoder output).
- `--export_path PATH` (asr_inference) writes the restored student's
  serving artifact (convert/export.py: one torch.export program a
  `--export_buckets` batch:seconds shape, the kernels inside as custom
  ops) and exits before evaluation.

The Trainer refuses, as JAX's does, `--cache_teacher` with flow matching,
DiffKD, diffm or all-scope layerwise KD (`--cache_teacher_all` serves
them) and a cache with `--steps_per_dispatch` > 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional


def str2bool(v):
    if isinstance(v, bool):
        return v
    v = v.lower()
    if v in ("yes", "true", "t", "y", "1"):
        return True
    if v in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected (true/false).")


def parse_sampling_steps_per_layer(s):
    """'random' -> 16 random picks from {1,2,4,8} (asr_train.py:1522-1528)."""
    if s == "random":
        return [random.choice([1, 2, 4, 8]) for _ in range(16)]
    return json.loads(s)


def parse_model_version(s) -> int:
    """'ver3' | '3' | 3 -> 3."""
    if isinstance(s, int):
        return s
    s = str(s)
    return int(s[3:]) if s.startswith("ver") else int(s)


# ---------------------------------------------------------------------------
# argument surfaces
# ---------------------------------------------------------------------------

def add_common_data_args(p: argparse.ArgumentParser):
    p.add_argument("--platform", type=str, default="", choices=["", "cpu"],
                   help="'' runs on the CUDA card (an error without one); "
                        "'cpu' runs on the CPU")
    p.add_argument("--host_devices", type=int, default=0,
                   help="with --platform cpu: number of CPU ranks of "
                        "data-parallel training (gloo)")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_sample_rate", type=int, default=16000)
    p.add_argument("--decode_cache_dir", type=str, default=None,
                   help="decoded-audio disk cache dir: repeated passes "
                        "skip the host decode (data/dataset.py)")
    p.add_argument("--data_script_path", type=str,
                   default="./librispeech_asr.py")
    p.add_argument("--data_config_name", type=str, default="train_100")
    p.add_argument("--data_train_split", type=str, default="train.clean.100")
    p.add_argument("--data_val_split", type=str, default="dev.clean")
    p.add_argument("--data_test_split", type=str, default="test.clean")
    p.add_argument("--test_mode", action="store_true")
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--cache_teacher", action="store_true")
    p.add_argument("--cache_teacher_all", action="store_true")
    p.add_argument("--cache_teacher_dir", type=str, default=None)
    p.add_argument("--teacher_int8", action="store_true",
                   help="run the frozen teacher's FFN sublayers in int8")
    p.add_argument("--train_manifest", type=str, default=None)
    p.add_argument("--val_manifest", type=str, default=None)
    p.add_argument("--test_manifest", type=str, default=None)
    p.add_argument("--teacher_nemo", type=str, default=None,
                   help="local .nemo of the teacher (offline replacement "
                        "for from_pretrained stt_en_conformer_ctc_small)")
    p.add_argument("--tokenizer", type=str, default=None)


def add_kd_args(p: argparse.ArgumentParser):
    p.add_argument("--use_ctc", type=str2bool, default=True)
    p.add_argument("--use_logit_distillation", type=str2bool, default=False)
    p.add_argument("--kd_alpha", type=float, default=1.0)
    p.add_argument("--kd_temperature", type=float, default=1.0)
    p.add_argument("--use_layerwise_distillation", type=str2bool,
                   default=False)
    p.add_argument("--layer_kd_alpha", type=float, default=1.0)
    p.add_argument("--layer_kd_scope", type=str, default="all",
                   choices=["all", "last"])
    p.add_argument("--use_flow_matching", type=str2bool, default=False)
    p.add_argument("--flow_steps", type=int, default=8)
    p.add_argument("--dirac_ratio", type=float, default=0.1)  # parsed, unused
    p.add_argument("--flow_weight", type=float, default=1.0)
    p.add_argument("--flow_schedule", type=str, default="rectified",
                   choices=["rectified", "vp_ode", "ve_ode"])
    p.add_argument("--meta_encoder_type", type=str, default="mlp",
                   choices=["mlp", "cnn", "swin", "conformer", "unet"])
    p.add_argument("--shape_transform_type", type=str, default="linear",
                   choices=["identity", "linear", "conv1d"])
    p.add_argument("--sampling_steps_per_layer",
                   type=parse_sampling_steps_per_layer, default=None)
    p.add_argument("--use_diffkd", type=str2bool, default=False)
    p.add_argument("--diffkd_steps", type=int, default=5)
    p.add_argument("--use_dynamic_steps", type=str2bool, default=False)
    p.add_argument("--router_weight", type=float, default=1.0)
    p.add_argument("--router_temperature", type=float, default=1.0)
    p.add_argument("--router_max_sampling_steps", type=int, default=8)
    p.add_argument("--router_strategy", type=str, default="batch_mode",
                   choices=["batch_mode", "batch_avg", "batch_median",
                            "group"])


def build_train_parser(description: str, gigaspeech: bool = False,
                       diffm: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    add_common_data_args(p)
    add_kd_args(p)
    p.add_argument("--config", type=str,
                   default="configs/conformer_ctc_small.yaml")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--gpus", type=int, default=1,
                   help="ranks of data-parallel training, one a card "
                        "(-1: every visible card); with --platform cpu, "
                        "CPU ranks (gloo)")
    p.add_argument("--resume_ckpt", type=str, default=None,
                   help="a checkpoint file (e.g. <output_dir>/run/"
                        "checkpoints/last) to continue from; it must exist")
    if gigaspeech:
        p.add_argument("--train_student_model", type=str2bool, default=True)
    p.add_argument("--train_teacher_model", type=str2bool, default=False)
    if diffm:
        p.add_argument("--model_version", type=parse_model_version,
                       default=1)
        p.add_argument("--latent_dim", type=int, default=96)
        p.add_argument("--kd_loss_type", type=str, default="mse",
                       choices=["mse", "l1"])
    return p


def build_inference_parser(description: str, diffm: bool = False):
    p = argparse.ArgumentParser(description=description)
    add_common_data_args(p)
    add_kd_args(p)
    p.add_argument("--ckpt_path", type=str, required=True)
    p.add_argument("--config", type=str, default=None,
                   help="model-config yaml for checkpoints trained WITHOUT "
                        "a teacher .nemo; must match the training run's "
                        "--config")
    p.add_argument("--gpus", type=int, default=1)
    p.add_argument("--eval_data", type=str, default="librispeech",
                   choices=["librispeech", "tedlium2", "commonvoice",
                            "gigaspeech"])
    p.add_argument("--is_teacher", type=str2bool, default=False)
    p.add_argument("--packed_eval", action="store_true",
                   help="packed-segment evaluation: several utterances a "
                        "row of the encoder (Trainer.evaluate_packed)")
    # serialized serving artifact (torch.export with the kernels as custom
    # ops; the ExportableEncDecModel equivalent, convert/export.py)
    p.add_argument("--export_path", type=str, default=None,
                   help="write a .tasrx serialized-inference artifact of "
                        "the restored student and exit before evaluation")
    p.add_argument("--export_buckets", type=str, default="8:4,8:8,8:16",
                   help="comma-separated batch:seconds static shapes for "
                        "--export_path")
    if diffm:
        p.add_argument("--model_ver", type=parse_model_version, default=1)
        p.add_argument("--latent_dim", type=int, default=96)
    return p


# ---------------------------------------------------------------------------
# config assembly
# ---------------------------------------------------------------------------

def assemble_distill_config(args, student_cfg, teacher_cfg,
                            diffm_version=None):
    from tpu_asr_torch.config import (DiffKDConfig, DiffmConfig,
                                      DistillationConfig, FlowMatchingConfig,
                                      RouterConfig)

    s_d = student_cfg.encoder.d_model
    t_d = teacher_cfg.encoder.d_model
    flow = router = None
    if args.use_flow_matching or args.use_diffkd or diffm_version is not None:
        flow = FlowMatchingConfig(
            meta_encoder_type=args.meta_encoder_type,
            time_embed_dim=32,
            hidden_dim=getattr(args, "latent_dim", None) or 128,
            training_sampling=args.flow_steps,
            inference_sampling=args.flow_steps,
            weight=args.flow_weight,
            student_dim=s_d, teacher_dim=t_d,
            student_head_num=student_cfg.encoder.n_heads,
            teacher_head_num=teacher_cfg.encoder.n_heads,
            shape_transform=args.shape_transform_type,
            loss="mse",
            noise_schedule=args.flow_schedule,
            sampling_steps_per_layer=(tuple(args.sampling_steps_per_layer)
                                      if args.sampling_steps_per_layer
                                      else None),
            use_dynamic_steps=args.use_dynamic_steps,
            router_strategy=args.router_strategy,
            router_weight=args.router_weight,
            router_max_sampling_steps=args.router_max_sampling_steps,
            router_temperature=args.router_temperature)
        router = RouterConfig(
            max_steps=args.router_max_sampling_steps, min_steps=1,
            stu_dim=s_d, tch_dim=t_d,
            use_layer_id=True, num_layers=student_cfg.encoder.n_layers,
            layer_emb_dim=32, temperature=args.router_temperature,
            budget_target=8.0, budget_weight=0.05, entropy_weight=0.001)
    diffkd = None
    if args.use_diffkd:
        diffkd = DiffKDConfig(steps=args.diffkd_steps, teacher_dim=t_d,
                              student_dim=s_d, latent_dim=s_d)
    diffm = None
    if diffm_version is not None:
        diffm = DiffmConfig(model_version=diffm_version,
                            latent_dim=getattr(args, "latent_dim", 96),
                            student_dim=s_d, teacher_dim=t_d, fm=flow)
    return DistillationConfig(
        use_ctc=args.use_ctc,
        use_logit_distillation=args.use_logit_distillation,
        kd_alpha=args.kd_alpha, kd_temperature=args.kd_temperature,
        use_layerwise_distillation=args.use_layerwise_distillation,
        layer_kd_alpha=args.layer_kd_alpha,
        layer_kd_scope=getattr(args, "layer_kd_scope", "all"),
        use_flow_matching=args.use_flow_matching, flow=flow,
        router=router if (flow is not None and flow.use_dynamic_steps)
        else None,
        use_diffkd=args.use_diffkd, diffkd=diffkd,
        use_diffm=diffm_version is not None, diffm=diffm)


def load_teacher(args):
    """(teacher_cfg, teacher state_dict or None, tokenizer or None)."""
    from tpu_asr_torch.config import ModelConfig
    from tpu_asr_torch.convert.nemo_import import (
        load_nemo_checkpoint, nemo_config_to_model_config, read_yaml)
    from tpu_asr_torch.data.tokenizer import SentencePieceBPETokenizer

    tokenizer = None
    if args.teacher_nemo:
        with tempfile.TemporaryDirectory(prefix="nemo_") as tmp:
            cfg, sd, tok_path = load_nemo_checkpoint(args.teacher_nemo, tmp)
            if args.tokenizer:
                tokenizer = SentencePieceBPETokenizer.from_file(
                    args.tokenizer)
            elif tok_path:
                tokenizer = SentencePieceBPETokenizer.from_file(tok_path)
        return cfg, sd, tokenizer

    print("WARNING: no --teacher_nemo given — teacher weights are RANDOMLY "
          "initialized (offline environment; the reference downloads "
          "stt_en_conformer_ctc_small from NGC).", file=sys.stderr)
    cfg_path = getattr(args, "config", None)
    if cfg_path and os.path.isfile(cfg_path):
        cfg = nemo_config_to_model_config(read_yaml(cfg_path))
    else:
        cfg = ModelConfig()
    if args.tokenizer:
        tokenizer = SentencePieceBPETokenizer.from_file(args.tokenizer)
    return cfg, None, tokenizer


def prepare_manifests(args, corpus: str) -> Dict[str, str]:
    """Manifest resolution, as JAX's: explicit manifests win ("path", or
    "name=path,name=path" for the val and test flags); otherwise each split
    is built once from the Hugging Face dataset `--data_script_path`
    (`load_dataset`, reference asr_train.py:1615-1681) into
    `<data_dir>/manifests/`, with --test_mode's 100-sample reduction. That
    needs the `datasets` package, imported only here: without it, or
    without the script's file, SystemExit names what is missing."""
    explicit = {"train": args.train_manifest, "val": args.val_manifest,
                "test": args.test_manifest}
    if any(explicit.values()):
        out = {}
        for k, v in explicit.items():
            if not v:
                continue
            if "=" in v:
                for part in v.split(","):
                    name, path = part.split("=", 1)
                    out[name] = path
            else:
                out[k] = v
        return out

    script = args.data_script_path
    if script.endswith(".py") and not os.path.isfile(script):
        raise SystemExit(f"--data_script_path {script}: no such file (pass "
                         "--train_manifest / --val_manifest / "
                         "--test_manifest, or a dataset script)")
    try:
        from datasets import load_dataset
    except ImportError:
        raise SystemExit(
            f"building {corpus} manifests from --data_script_path {script} "
            "needs the `datasets` package, which is not installed; pass "
            "--train_manifest / --val_manifest / --test_manifest") from None

    from tpu_asr_torch.data.manifest import build_manifest_from_hf

    manifest_dir = os.path.join(args.data_dir, "manifests")
    os.makedirs(manifest_dir, exist_ok=True)
    cache_dir = os.path.join(args.data_dir, "cache")
    splits = {"train": args.data_train_split, "val": args.data_val_split,
              "test": args.data_test_split}
    manifests = {}
    for name, split in splits.items():
        if not split:                  # e.g. inference CLIs with no train set
            continue
        suffix = "_testmode" if args.test_mode else ""
        path = os.path.join(manifest_dir, f"{name}{suffix}.json")
        if not os.path.isfile(path):
            ds = load_dataset(script, args.data_config_name, split=split,
                              trust_remote_code=True, cache_dir=cache_dir,
                              token=getattr(args, "hf_token", None))
            if args.test_mode:
                ds = ds.select(range(min(100, len(ds))))
            build_manifest_from_hf(ds, path, cache_dir, corpus=corpus)
        manifests[name] = path
    if args.test_mode:
        args.epochs = 5
    return manifests


def on_ranks(run, args, *rest):
    """From a process outside any group: (True, run(args, *rest)) in a
    launcher's group (torchrun's WORLD_SIZE) or on the N ranks that the
    flags ask for, started here (parallel/launch.py; rank 0's value);
    (False, None) when they ask for one rank, which the caller runs in this
    process."""
    from tpu_asr_torch.parallel import mesh
    from tpu_asr_torch.parallel.launch import launch

    if "WORLD_SIZE" in os.environ:             # a launcher's rank (torchrun)
        mesh.init_distributed(device="cpu" if args.platform == "cpu"
                              else None)
        try:
            return True, run(args, *rest)
        finally:
            mesh.shutdown()
    devices = rank_devices(args)
    if len(devices) > 1:
        return True, launch(run, (args, *rest), devices=devices,
                            timeout=None)[0]
    return False, None


def device_of(args) -> str:
    """'cpu' with --platform cpu, else 'cuda' (this rank's card in a
    process group); SystemExit without a card."""
    if getattr(args, "platform", "") == "cpu":
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tpu_asr_torch: no CUDA device; pass --platform "
                         "cpu to run on the CPU")
    from tpu_asr_torch.parallel import mesh
    if mesh.initialized():
        return f"cuda:{torch.cuda.current_device()}"
    return "cuda"


def rank_devices(args):
    """The devices of the ranks the flags ask for: N CPU ranks for
    --platform cpu with --host_devices N or --gpus N, else one card a rank
    (--gpus N, -1 for every visible card). SystemExit for more cards than
    are visible."""
    gpus = getattr(args, "gpus", 1)
    hosts = getattr(args, "host_devices", 0)
    if getattr(args, "platform", "") == "cpu":
        return ["cpu"] * max(hosts, gpus, 1)
    if hosts > 1:
        raise SystemExit(f"tpu_asr_torch: --host_devices {hosts} starts CPU "
                         "ranks; pass --platform cpu (or --gpus N for cards)")
    device_of(args)
    import torch
    seen = torch.cuda.device_count()
    n = seen if gpus == -1 else max(gpus, 1)
    if n > seen:
        raise SystemExit(f"tpu_asr_torch: --gpus {gpus} asks for {n} cards; "
                         f"{seen} visible")
    return [f"cuda:{i}" for i in range(n)]


# ---------------------------------------------------------------------------
# run paths
# ---------------------------------------------------------------------------

def _sync_vocab(teacher_cfg, tokenizer, frozen: bool):
    """Align the decoder's num_classes with the tokenizer: an imported
    (frozen) teacher fixes it, and the tokenizer must fit inside; else the
    tokenizer's size is taken."""
    if frozen:
        if tokenizer.vocab_size > teacher_cfg.decoder.num_classes:
            raise ValueError(
                f"tokenizer vocab ({tokenizer.vocab_size}) exceeds the "
                f"teacher decoder ({teacher_cfg.decoder.num_classes})")
        return teacher_cfg
    return dataclasses.replace(
        teacher_cfg, decoder=dataclasses.replace(
            teacher_cfg.decoder, num_classes=tokenizer.vocab_size))


def _fallback_tokenizer(manifests, vocab_size=128):
    from tpu_asr_torch.data.manifest import read_manifest
    from tpu_asr_torch.data.tokenizer import train_bpe

    texts = [e.text for m in manifests.values() for e in read_manifest(m)]
    print(f"training fallback BPE tokenizer (vocab {vocab_size}) on "
          f"{len(texts)} transcripts", file=sys.stderr)
    return train_bpe(texts, vocab_size=vocab_size)


def _build(args, manifests, train_teacher: bool, diffm_version,
           tok_side=None):
    """(student_cfg, teacher_cfg, model, teacher state_dict or None,
    tokenizer) from the flags; `train_teacher` trains the teacher's own
    configuration (the reference's R1 baseline). The model's weights are
    drawn from seed 0 on the CPU."""
    import torch

    from tpu_asr_torch.config import make_student_config
    from tpu_asr_torch.data.tokenizer import SentencePieceBPETokenizer
    from tpu_asr_torch.models.distil_model import DistilCTCModel

    teacher_cfg, teacher_sd, tokenizer = load_teacher(args)
    if tokenizer is None and tok_side is not None and tok_side.is_file():
        tokenizer = SentencePieceBPETokenizer.from_file(tok_side)
    if tokenizer is None:
        tokenizer = _fallback_tokenizer(manifests,
                                        teacher_cfg.decoder.num_classes)
    teacher_cfg = _sync_vocab(teacher_cfg, tokenizer,
                              frozen=teacher_sd is not None)
    student_cfg = teacher_cfg if train_teacher else \
        make_student_config(teacher_cfg)
    if getattr(args, "teacher_int8", False) and not train_teacher:
        teacher_cfg = dataclasses.replace(
            teacher_cfg, encoder=dataclasses.replace(
                teacher_cfg.encoder, quantization="int8"))
    distill = assemble_distill_config(args, student_cfg, teacher_cfg,
                                      diffm_version)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DistilCTCModel(student_cfg, teacher_cfg, distill)
    return student_cfg, teacher_cfg, model, teacher_sd, tokenizer


def _train_config(args, student_cfg, distill, train: bool):
    from tpu_asr_torch.config import (DataConfig, OptimConfig, TrainConfig)
    from tpu_asr_torch.parallel import mesh

    ds = dict(sample_rate=args.data_sample_rate, batch_size=args.batch_size,
              decode_cache_dir=args.decode_cache_dir)
    kw = dict(train_ds=DataConfig(shuffle=True, **ds),
              validation_ds=DataConfig(shuffle=False, **ds),
              max_epochs=args.epochs) if train else {}
    return TrainConfig(model=student_cfg, distillation=distill,
                       optim=OptimConfig(d_model=student_cfg.encoder.d_model),
                       test_ds=DataConfig(shuffle=False, **ds),
                       steps_per_dispatch=args.steps_per_dispatch,
                       cache_teacher=args.cache_teacher,
                       cache_teacher_all=args.cache_teacher_all,
                       cache_teacher_dir=args.cache_teacher_dir,
                       dp_size=mesh.process_count(), **kw)


def run_training(args, corpus: str = "librispeech",
                 diffm_version: Optional[int] = None) -> Dict[str, Dict]:
    """Train from the flags; data-parallel when they ask for more than one
    rank (the module's docstring). The results are rank 0's."""
    from tpu_asr_torch.parallel import mesh
    from tpu_asr_torch.train.loop import Trainer
    from tpu_asr_torch.utils.checkpoint import export_student

    if args.resume_ckpt is not None and not os.path.isfile(args.resume_ckpt):
        raise SystemExit(f"--resume_ckpt {args.resume_ckpt}: no such "
                         "checkpoint file")
    if not mesh.initialized():
        ran, results = on_ranks(run_training, args, corpus, diffm_version)
        if ran:
            return results
    device = device_of(args)
    main = mesh.is_main_process()
    manifests = prepare_manifests(args, corpus)
    train_teacher = getattr(args, "train_teacher_model", False) or \
        not getattr(args, "train_student_model", True)
    student_cfg, _, model, teacher_sd, tokenizer = _build(
        args, manifests, train_teacher, diffm_version)
    cfg = _train_config(args, student_cfg, model.distill, train=True)
    workdir = Path(args.output_dir) / (os.getenv("EXP_NAME") or "run")
    trainer = Trainer(model, cfg, tokenizer, workdir, device=device)
    if hasattr(tokenizer, "save") and main:
        trainer.ckpt_dir.mkdir(parents=True, exist_ok=True)
        tokenizer.save(trainer.ckpt_dir / "tokenizer.model")
    mesh.sync_processes("tokenizer_sidecar")
    trainer.init_state()
    if teacher_sd is not None and model.needs_teacher:
        trainer.load_teacher_params(teacher_sd)
    trainer.fit(manifests["train"], manifests.get("val"),
                resume_from=args.resume_ckpt)
    results = {}
    for split in ("val", "test"):
        if split in manifests:
            results[split] = trainer.evaluate(manifests[split])
            if main:
                print(f"[{split}] wer={results[split]['wer']:.4f} "
                      f"loss={results[split]['loss']:.4f} "
                      f"({int(results[split]['num_utts'])} utts)")
    export_student(trainer.ckpt_dir, trainer.state, student_cfg)
    return results


def run_inference(args, diffm_version: Optional[int] = None
                  ) -> Dict[str, Dict]:
    """Rebuild the distil model from the teacher config and the flags, load
    the checkpoint (`last` or a student export) and evaluate every split
    (asr_inference.py:304-471); on N ranks when the flags ask for them
    (the module's docstring), each evaluating its block of every batch.
    The results are rank 0's, which alone prints them."""
    import torch

    from tpu_asr_torch.parallel import mesh
    from tpu_asr_torch.train.loop import Trainer
    from tpu_asr_torch.utils.checkpoint import (load_student,
                                                restore_train_state)

    if not mesh.initialized():
        ran, results = on_ranks(run_inference, args, diffm_version)
        if ran:
            return results
    device = device_of(args)
    main = mesh.is_main_process()
    corpus = {"librispeech": "librispeech", "tedlium2": "tedlium",
              "commonvoice": "commonvoice", "gigaspeech": "gigaspeech"}[
        args.eval_data]
    manifests = prepare_manifests(args, corpus)
    ckpt = Path(args.ckpt_path)
    student_cfg, _, model, teacher_sd, tokenizer = _build(
        args, manifests, args.is_teacher, diffm_version,
        tok_side=ckpt.parent / "tokenizer.model")
    cfg = _train_config(args, student_cfg, model.distill, train=False)
    trainer = Trainer(model, cfg, tokenizer, Path(args.output_dir) / "infer",
                      device=device)
    trainer.init_state()
    if teacher_sd is not None and model.needs_teacher:
        trainer.load_teacher_params(teacher_sd)
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    if "model" in saved and "optimizer" in saved:
        trainer.state = restore_train_state(ckpt.parent, trainer.state,
                                            name=ckpt.name)
    else:
        load_student(ckpt, model.student)

    if getattr(args, "export_path", None):
        if main:
            from tpu_asr_torch.convert.export import export_inference
            buckets = [(int(b.split(":")[0]), float(b.split(":")[1]))
                       for b in args.export_buckets.split(",") if b]
            out = export_inference(model.student, tokenizer,
                                   args.export_path, buckets=buckets,
                                   device=device)
            print(f"serialized inference artifact: {out}")
        return {}

    packed = getattr(args, "packed_eval", False)
    if packed and model.distill.use_flow_matching:
        if main:
            print("WARNING: --packed_eval requires the plain CTC decode "
                  "path; flow-matching feeds the decoder from the FM output "
                  "— falling back to bucketed evaluate()", file=sys.stderr)
        packed = False
    results = {}
    for split, manifest in manifests.items():
        results[split] = (trainer.evaluate_packed(manifest) if packed
                          else trainer.evaluate(manifest))
        if main:
            print(f"[{args.eval_data}/{split}] "
                  f"wer={results[split]['wer']:.4f} "
              f"loss={results[split]['loss']:.4f} "
              f"({int(results[split]['num_utts'])} utts)")
    return results
