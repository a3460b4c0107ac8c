"""Data parallelism of the port in one process (tpu_asr_torch/parallel/,
the agreed batch plan of data/dataset.py, the CLI's rank flags); the tests
that start ranks are in tests/test_torch_ddp.py.

- without a process group every helper of parallel/mesh.py is the identity
  or a no-op, so a single-rank run is unchanged;
- the agreed plan: at 2 ranks both blocks of every step have the same
  shapes, and they concatenate to the single-rank batch of the same plan
  padded cyclically to a multiple of 2 (JAX's pad_batch_to=dp_size),
  `texts` keeping only real rows, also for a fit resumed mid-epoch;
- the reference's loader fault: JAX's make_dataloader striped over two
  processes (num_shards=2) yields batch counts and padded lengths that
  disagree between the stripes, on a manifest whose durations span
  buckets (ROADMAP.md, "Faults of the reference");
- every random draw of the student's training forward (dither,
  SpecAugment, the dropout masks of every site) on a rank's rows equals the
  single-rank draw on those rows: ranks played in turn by setting the
  group's rank and size (a layer-norm conv module, so no collective is
  needed), and shift_seeds' streams;
- the refusals: packed training at more than one rank, the Trainer's
  dp_size against the world size, `--gpus N` above the visible cards and
  `--host_devices` without `--platform cpu`.
"""

import types

import numpy as np
import pytest
import torch

import tpu_asr_torch.config as PC
from test_torch_fit import corpus
from tpu_asr.config import DataConfig as JaxDataConfig
from tpu_asr.data.dataset import AudioToBPEDataset as JaxDataset
from tpu_asr.data.dataset import make_dataloader as jax_make_dataloader
from tpu_asr.data.tokenizer import train_bpe as jax_train_bpe
from tpu_asr_torch.data.dataset import AudioToBPEDataset, make_dataloader
from tpu_asr_torch.data.tokenizer import train_bpe
from tpu_asr_torch.models.conformer import SEEDS_PER_LAYER, shift_seeds
from tpu_asr_torch.models.ctc_model import CTCModel
from tpu_asr_torch.ops.dropout import batch_streams
from tpu_asr_torch.parallel import mesh
from tpu_asr_torch.train.trainer import step_rngs


def test_mesh_helpers_without_a_group():
    x = torch.arange(6.0).reshape(2, 3)
    assert not mesh.initialized()
    assert (mesh.process_count(), mesh.process_index()) == (1, 0)
    assert mesh.is_main_process()
    assert mesh.cross_process_sum([1.5, 2]).tolist() == [1.5, 2.0]
    assert mesh.broadcast_int(7) == 7
    assert mesh.any_process(True) and not mesh.any_process(False)
    mesh.sync_processes("nothing")
    assert mesh.row_offset(5) == 0 and mesh.global_rows(5) == 5
    assert mesh.all_reduce_sum(x) is x and mesh.all_gather_rows(x) is x
    assert torch.equal(mesh.global_sum(x), x)
    assert torch.equal(mesh.global_mean(x, (0, 1)), x.mean(dim=(0, 1)))
    assert torch.equal(mesh.batch_mean(x), x.mean())
    assert mesh.local_rows(x) is x
    gen = lambda: torch.Generator().manual_seed(3)
    g1, g2 = gen(), gen()
    assert torch.equal(mesh.draw_rows(lambda s: torch.rand(s, generator=g1),
                                      (2, 4)), torch.rand(2, 4, generator=g2))
    assert shift_seeds([5, 6], 0, 4) == [5, 6]


def _as_rank(monkeypatch, rank, world):
    monkeypatch.setattr(mesh, "process_index", lambda: rank)
    monkeypatch.setattr(mesh, "process_count", lambda: world)


def _plan(ds, cfg, **kw):
    return list(make_dataloader(ds, cfg, num_workers=1, **kw))


@pytest.mark.parametrize("skip", [0, 1])
def test_agreed_plan_blocks_concatenate_to_one_rank(tmp_path, skip):
    man, texts = corpus(tmp_path, n=9, seed=13, lo=0.5, hi=6.0)
    ds = AudioToBPEDataset(man, train_bpe(texts, 28))
    cfg = PC.DataConfig(batch_size=3, shuffle=True)
    one = _plan(ds, cfg, pad_batch_to=2, skip_batches=skip)
    ranks = [_plan(ds, cfg, world=2, rank=r, skip_batches=skip)
             for r in range(2)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) > 1
    for step, (whole, a, b) in enumerate(zip(one, *ranks)):
        for k in ("signal", "signal_len", "tokens", "token_len", "utt_idx"):
            assert a[k].shape == b[k].shape, (step, k)
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]),
                                          whole[k], err_msg=f"{step} {k}")
        assert a["texts"] + b["texts"] == whole["texts"]
        assert len(a["texts"]) == a["signal"].shape[0]     # real rows first
    with pytest.raises(ValueError, match="world > 1"):
        _plan(ds, cfg, world=2, rank=0, num_shards=2)


def test_reference_loader_stripes_disagree(tmp_path):
    """JAX's multi-process loader stripes the shuffled manifest and plans
    each stripe alone (tpu_asr/data/dataset.py:161-198): on this manifest
    its two processes disagree on the number of batches and on the padded
    signal length at every step, so a global batch assembled from them
    (make_array_from_process_local_data) would not have one shape, and one
    process would wait for a step the other never takes."""
    man, texts = corpus(tmp_path, n=9, seed=13, lo=0.5, hi=6.0)
    ds = JaxDataset(man, jax_train_bpe(texts, 28))
    cfg = JaxDataConfig(batch_size=2, shuffle=True)
    shapes = [[b["signal"].shape for b in jax_make_dataloader(
        ds, cfg, num_shards=2, shard_index=s, num_workers=1)]
        for s in range(2)]
    assert shapes == [[(1, 66800), (1, 100200), (2, 33400), (1, 33400)],
                      [(2, 66800), (2, 100200)]]
    port = [[b["signal"].shape for b in _plan(
        AudioToBPEDataset(man, train_bpe(texts, 28)),
        PC.DataConfig(batch_size=4, shuffle=True), world=2, rank=r)]
        for r in range(2)]
    assert port[0] == port[1]


def test_rank_rows_draw_the_single_rank_masks(monkeypatch):
    """The student's training encode (dither, SpecAugment, dropout 0.3 at
    every site) of a rank's rows equals the single-rank encode's rows."""
    enc = PC.EncoderConfig(feat_in=24, n_layers=2, d_model=16, n_heads=2,
                           conv_kernel_size=7, conv_norm_type="layer_norm",
                           dropout=0.3, dropout_pre_encoder=0.3,
                           dropout_att=0.3)
    cfg = PC.ModelConfig(preprocessor=PC.PreprocessorConfig(features=24,
                                                            dither=1e-3),
                         spec_augment=PC.SpecAugmentConfig(), encoder=enc,
                         decoder=PC.DecoderConfig(feat_in=16,
                                                  num_classes=16),
                         compute_dtype="float32")
    torch.manual_seed(0)
    model = CTCModel(cfg).train()
    rng = np.random.default_rng(4)
    sig = torch.from_numpy((rng.normal(size=(4, 12000)) * 0.1).astype(
        np.float32))
    lens = torch.tensor([12000, 9000, 11000, 5000])
    with torch.no_grad():
        want, _, want_feats = model.encode(sig, lens, True,
                                           step_rngs(3, 5, "cpu"))
        for r in range(2):
            _as_rank(monkeypatch, r, 2)
            got, _, feats = model.encode(sig[2 * r:2 * r + 2],
                                         lens[2 * r:2 * r + 2], True,
                                         step_rngs(3, 5, "cpu"))
            torch.testing.assert_close(got, want[2 * r:2 * r + 2], rtol=0,
                                       atol=1e-5)
            torch.testing.assert_close(feats, want_feats[:, 2 * r:2 * r + 2],
                                       rtol=0, atol=1e-5)


def test_shift_seeds_moves_each_stream_by_its_rows():
    seeds = list(range(100, 100 + 1 + 2 * SEEDS_PER_LAYER))
    shifted = shift_seeds(seeds, 3, 4)
    per_row = [1] + [1, 4, 1, 1, 1] * 2
    for s, t, k in zip(seeds, shifted, per_row):
        # rows 3.. of the single-rank streams are rows 0.. of the shifted
        want = batch_streams(s, 5, per_row=k)[3:]
        np.testing.assert_array_equal(batch_streams(t, 2, per_row=k), want)
    assert shift_seeds([2 ** 32 - 1], 2, 4) == [1]


@pytest.mark.parametrize("change,unused", [
    ({}, False), ({"use_diffkd": True}, True), ({"use_ctc": False}, True),
    ({"use_ctc": False, "use_logit_distillation": True}, False)])
def test_unused_parameters_possible(change, unused):
    """DDP looks for parameters without a gradient only where a
    configuration can leave some: DiffKD's teacher encoder, a decoder no
    loss reads."""
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.train.trainer import unused_parameters_possible

    teacher = PC.ModelConfig(encoder=PC.EncoderConfig(
        n_layers=1, d_model=16, n_heads=2, conv_kernel_size=7),
        decoder=PC.DecoderConfig(feat_in=16, num_classes=8))
    student = PC.make_student_config(teacher)
    d = PC.DistillationConfig(diffkd=PC.DiffKDConfig(
        steps=2, teacher_dim=16, student_dim=8, latent_dim=8), **change)
    assert unused_parameters_possible(
        DistilCTCModel(student, teacher, d)) == unused


def test_packed_training_refused_at_two_ranks(monkeypatch):
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.train.trainer import make_distil_train_step

    teacher = PC.ModelConfig(encoder=PC.EncoderConfig(
        n_layers=1, d_model=16, n_heads=2, conv_kernel_size=7),
        decoder=PC.DecoderConfig(feat_in=16, num_classes=8))
    model = DistilCTCModel(teacher, teacher)
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="packed training"):
        make_distil_train_step(model, packed=True)


@pytest.mark.parametrize("dp_size,world,refused", [
    (-1, 2, False), (2, 2, False), (1, 2, True), (4, 2, True)])
def test_trainer_dp_size_against_the_world(monkeypatch, dp_size, world,
                                           refused):
    from tpu_asr_torch.train.loop import refusals

    monkeypatch.setattr(mesh, "process_count", lambda: world)
    assert bool(refusals(PC.TrainConfig(dp_size=dp_size))) == refused
    assert refusals(PC.TrainConfig(dp_size=-1, tp_size=2))


def test_cli_rank_devices(monkeypatch):
    from tpu_asr_torch.cli import asr_train
    from tpu_asr_torch.cli.common import rank_devices

    ns = lambda **kw: types.SimpleNamespace(**{
        "platform": "", "gpus": 1, "host_devices": 0, **kw})
    assert rank_devices(ns(platform="cpu", gpus=2)) == ["cpu", "cpu"]
    assert rank_devices(ns(platform="cpu", host_devices=3)) == ["cpu"] * 3
    assert rank_devices(ns(platform="cpu")) == ["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_devices(ns(gpus=-1)) == ["cuda:0"]
    with pytest.raises(SystemExit, match="--gpus 2 asks for 2 cards; 1 "
                                         "visible"):
        asr_train.main(["--gpus", "2", "--train_manifest", "t.jsonl"])
    with pytest.raises(SystemExit, match="--host_devices 2 starts CPU"):
        asr_train.main(["--host_devices", "2", "--train_manifest",
                        "t.jsonl"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_devices(ns(gpus=-1)) == [f"cuda:{i}" for i in range(4)]
    assert rank_devices(ns(gpus=2)) == ["cuda:0", "cuda:1"]
