"""Data parallelism of the port (tpu_asr_torch/parallel/, the agreed batch
plan of data/dataset.py, the CLI's rank flags): in one process, and, for
packed training, the teacher caches and inference at N ranks, in one launch
of 2 ranks (the other rank tests are in tests/test_torch_ddp.py).

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
- packed training at N ranks: a plan split by its rows
  (mesh.packed_rank_block) and the helpers inside utterance_rows; in ONE
  launch of 2 gloo ranks (tests/torch_ddp_ranks.py), 2 packed steps of
  logit KD + FM and of the routed ('batch_median') conformer meta encoder
  (dropout 0.1, SpecAugment, dither, BatchNorm) against one rank on the
  same plan, a 2-epoch fit with the teacher cache in RAM and in a
  directory against one rank's fit, and asr_inference at `--host_devices
  2` against one rank;
- the refusals: the Trainer's dp_size against the world size, `--gpus N`
  above the visible cards and `--host_devices` without `--platform cpu`.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
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


# the packed batch of the 2-rank tests: 6 utterances whose plan (rows of
# PACK_T frames, row_multiple 2) puts utterances 0, 2, 3, 4 in rows 0-1
# (rank 0) and 1, 5 in rows 2-3 (rank 1), row 3 all guard: the ranks'
# utterances are neither blocks nor equal in number
PACK_LENS, PACK_T = [16000, 4000, 15000, 7000, 5000, 12000], 48
PACKED = {"logit_fm": ("logit_fm", {}),
          "meta_router": ("router_median", {"meta_encoder_type":
                                            "conformer"})}


def packed_batch(student, seed=5):
    """PACK_LENS clips with their training plan at row_multiple 2."""
    from tpu_asr_torch.data.packing import train_pack_arrays

    rng = np.random.default_rng(seed)
    lens = np.asarray(PACK_LENS, np.int32)
    n = len(lens)
    sig = (rng.normal(size=(n, lens.max())) * 0.1).astype(np.float32)
    sig[np.arange(lens.max())[None, :] >= lens[:, None]] = 0.0
    pre, enc = student.preprocessor, student.encoder
    pk, plan = train_pack_arrays(lens, pre.n_fft, pre.hop_length,
                                 enc.subsampling_factor, enc.subsampling,
                                 enc.conv_kernel_size, PACK_T,
                                 row_multiple=2)
    assert plan.row.tolist() == [0, 2, 1, 0, 1, 2] and plan.n_rows == 4
    return {"signal": sig, "signal_len": lens,
            "tokens": rng.integers(0, 16, size=(n, 6)).astype(np.int32),
            "token_len": np.array([6, 2, 5, 3, 2, 4], np.int32), **pk}


def test_packed_rank_block_splits_one_plan():
    """Each rank takes its half of the packed rows and the utterances they
    hold; the parts put back together are the global plan."""
    import ddp_cases as C

    _, student = C.configs(PC)
    batch = packed_batch(student)
    parts = [mesh.packed_rank_block(batch, 2, r) for r in range(2)]
    assert [p["pk_utt"].tolist() for p in parts] == [[0, 2, 3, 4], [1, 5]]
    for r, p in enumerate(parts):
        assert p["pk_n_utt"] == 6 and p["pk_seg"].shape == (2, PACK_T)
        utt = p["pk_utt"]
        for k in ("signal", "signal_len", "tokens", "token_len",
                  "pk_start"):
            np.testing.assert_array_equal(p[k], batch[k][utt], err_msg=k)
        np.testing.assert_array_equal(p["pk_row"] + 2 * r,
                                      batch["pk_row"][utt])
        rows = slice(2 * r, 2 * r + 2)
        for k in ("pk_seg", "pk_src_pos"):
            np.testing.assert_array_equal(p[k], batch[k][rows], err_msg=k)
        valid = p["pk_seg"] > 0
        np.testing.assert_array_equal(utt[p["pk_src_utt"]][valid],
                                      batch["pk_src_utt"][rows][valid])
        assert (p["pk_src_utt"][~valid] == 0).all()
    with pytest.raises(ValueError, match="row_multiple=3"):
        mesh.packed_rank_block(batch, 3, 0)
    lone = dict(batch, pk_row=np.zeros(6, np.int32))
    with pytest.raises(ValueError, match="rank 1 of 2 holds no utterance"):
        mesh.packed_rank_block(lone, 2, 1)


def test_utterance_rows_take_global_places(monkeypatch):
    """Inside utterance_rows the helpers take a rank's rows at their global
    places: draws, shares, row indices (k rows an utterance too)."""
    _as_rank(monkeypatch, 1, 2)
    gen = lambda: torch.Generator().manual_seed(11)
    want = torch.rand(6, 4, generator=gen())
    g = gen()
    with mesh.utterance_rows(np.array([1, 5]), 6):
        got = mesh.draw_rows(lambda s: torch.rand(s, generator=g), (2, 4))
        assert mesh.row_share() == pytest.approx(2 / 6)
        assert mesh.global_rows(4) == 12
        assert mesh.row_index(4).tolist() == [2, 3, 10, 11]
        x = torch.arange(8.0).reshape(2, 4)
        assert mesh.batch_mean(x).item() == pytest.approx(
            x.sum().item() / 24)
        with pytest.raises(ValueError, match="not a block"):
            mesh.row_offset(2)
    np.testing.assert_array_equal(got.numpy(), want[[1, 5]].numpy())
    assert mesh.row_offset(3) == 3 and mesh.row_index(2).tolist() == [2, 3]


CLI_YAML = """preprocessor:
  features: 24
  dither: 0.0
encoder:
  feat_in: 24
  n_layers: 2
  d_model: 32
  n_heads: 4
  conv_kernel_size: 7
decoder:
  feat_in: 32
  num_classes: 28
"""


def cli_setup(root):
    """A student export of the CLI's own model (the tiny YAML's, weights
    moved off their seed), its tokenizer sidecar and a test manifest of 7
    clips; the asr_inference argv of one rank."""
    from tpu_asr_torch.cli.common import _build, build_inference_parser
    from tpu_asr_torch.train.trainer import DistilTrainState
    from tpu_asr_torch.utils.checkpoint import export_student

    man, texts = corpus(root, n=7, seed=17, lo=0.6, hi=1.4)
    (root / "tiny.yaml").write_text(CLI_YAML)
    ckpt = root / "checkpoints"
    ckpt.mkdir()
    train_bpe(texts, 28).save(ckpt / "tokenizer.model")
    argv = ["--platform", "cpu", "--test_manifest", man, "--config",
            str(root / "tiny.yaml"), "--ckpt_path", str(ckpt / "student"),
            "--batch_size", "4", "--output_dir", str(root / "out")]
    args = build_inference_parser("t").parse_args(argv)
    student, _, model, _, _ = _build(args, {"test": man}, False, None,
                                     ckpt / "tokenizer.model")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.student.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    export_student(ckpt, DistilTrainState.create(model, PC.OptimConfig()),
                   student)
    return argv


# the teacher caches at 2 ranks: in RAM (every harvest gathers the global
# batch's features) and in a directory (each rank writes its own rows)
CACHES = {"ram": lambda root: dict(cache_teacher=True),
          "dir": lambda root: dict(cache_teacher_all=True,
                                   cache_teacher_dir=str(root / "tcache"))}


def cache_fit_setup(root):
    """(student, teacher, distill, tokenizer, manifest, TrainConfig) of the
    cached fits: 6 clips of 0.6-1.0 s, global batches of 4 (2 a step, 4
    steps in 2 epochs), logit KD, dropout 0.1, SpecAugment and dither."""
    import dataclasses

    import ddp_cases as C

    root.mkdir()
    man, texts = corpus(root, n=6, seed=3, lo=0.6, hi=1.0)
    tok = train_bpe(texts, 28)
    teacher, student = C.configs(PC, dropout=0.1, spec=True, dither=1e-5)
    teacher = dataclasses.replace(teacher, decoder=dataclasses.replace(
        teacher.decoder, num_classes=tok.vocab_size))
    student = PC.make_student_config(teacher)
    d = PC.DistillationConfig(use_logit_distillation=True)
    ds = dict(batch_size=4, max_duration=16.7)
    cfg = PC.TrainConfig(
        model=student, distillation=d,
        optim=PC.OptimConfig(d_model=16, warmup_steps=10),
        train_ds=PC.DataConfig(shuffle=True, **ds), max_epochs=2)
    return student, teacher, d, tok, man, cfg


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank jobs of this module in one launch of 2 gloo CPU ranks:
    2 packed steps of each PACKED case, then asr_inference with
    --host_devices 2 (inside the group it runs on the rank)."""
    import dataclasses

    import ddp_cases as C
    import torch_ddp_ranks as R
    from tpu_asr_torch.models.distil_model import DistilCTCModel
    from tpu_asr_torch.parallel.launch import launch

    root = tmp_path_factory.mktemp("dist")
    jobs, cases = [], {}
    for name, (case, flow) in PACKED.items():
        teacher, student, d = C.case_configs(PC, case, dropout=0.1,
                                             spec=True, dither=1e-5)
        d = dataclasses.replace(d, flow=dataclasses.replace(d.flow, **flow))
        torch.manual_seed(0)
        sd = str(root / f"{name}.pt")
        torch.save(DistilCTCModel(student, teacher, d).state_dict(), sd)
        cases[name] = (student, teacher, d, sd, packed_batch(student), 2, 0,
                       None, True)
        jobs.append(("run_steps", cases[name]))
    fit = cache_fit_setup(root / "fit")
    for name, kw in CACHES.items():
        jobs.append(("fit_cached", (*fit[:5], str(root / name),
                                    dataclasses.replace(fit[5], **kw(root)))))
    (root / "cli").mkdir()
    argv = cli_setup(root / "cli")
    jobs.append(("run_cli", ("asr_inference", argv + ["--host_devices",
                                                      "2"])))
    ranks = launch(R.run_jobs, (jobs,), ["cpu", "cpu"], timeout=240,
                   coll_timeout=120, threads=2)
    return {"cases": cases, "ranks": ranks, "argv": argv, "fit": fit}


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_training_two_ranks_equal_one(two_ranks, name):
    """Two gloo ranks, each on its half of one plan (row_multiple 2), equal
    one rank on the whole plan: every loss and grad_norm of both steps at
    1e-5 relative, the first step's reduced gradients (1e-5 + 1e-4 x the
    tensor's max|ref|), BatchNorm's running statistics at 1e-5, the
    router's counts where their Gumbel margin exceeds 1e-3."""
    import torch_ddp_ranks as R

    case = two_ranks["cases"][name]
    two = two_ranks["ranks"][0][list(PACKED).index(name)]
    one = R.run_steps(*case)
    assert len(one["metrics"]) == 2
    for a, b in zip(one["metrics"], two["metrics"]):
        assert set(a) == set(b) and "grad_norm" in a
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    for k, w in one["grads"].items():
        np.testing.assert_allclose(two["grads"][k], w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=k)
    for k, w in one["stats1"].items():
        np.testing.assert_allclose(two["stats1"][k], w, rtol=0, atol=1e-5,
                                   err_msg=k)
    for (s1, m1), (s2, _) in zip(one["router"], two["router"]):
        sure = m1 > 1e-3
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(s2[sure], s1[sure])


@pytest.mark.parametrize("name", list(CACHES))
def test_cached_fit_two_ranks_equals_one_without(two_ranks, tmp_path, name):
    """A 2-epoch fit on 2 ranks with the cache in RAM (cache_teacher) or in
    a directory (cache_teacher_all) against the fit of one rank without a
    cache: every logged loss of the 4 steps at 1e-5 relative; the cached
    step ran in epoch 2 (its 2 steps) on both ranks, and each rank's cache
    holds all 6 utterances."""
    import torch_ddp_ranks as R

    student, teacher, d, tok, man, cfg = two_ranks["fit"]
    got = [r[len(PACKED) + list(CACHES).index(name)]
           for r in two_ranks["ranks"]]
    want, n_one, _, _ = R.fit_cached(student, teacher, d, tok, man,
                                     str(tmp_path / "one"), cfg)
    assert n_one == 0 and sorted(want) == [1, 2, 3, 4]
    losses = got[0][0]
    assert sorted(losses) == sorted(want)
    for step, row in want.items():
        assert set(losses[step]) == set(row)
        for k, v in row.items():
            np.testing.assert_allclose(losses[step][k], v, rtol=1e-5,
                                       err_msg=f"step {step} {k}")
    for _, n_cached, held, _ in got:
        assert n_cached == 2 and held == list(range(6))


def test_inference_cli_two_ranks_equal_one(two_ranks):
    """asr_inference --host_devices 2: WER equal to one rank's, loss at
    1e-5 relative, over all 7 clips; rank 0 alone prints."""
    from tpu_asr_torch.cli import asr_inference

    one = asr_inference.main(two_ranks["argv"])["test"]
    (got, printed0), (got1, printed1) = (r[-1] for r in two_ranks["ranks"])
    assert got == got1 and got["test"]["num_utts"] == one["num_utts"] == 7
    assert got["test"]["wer"] == one["wer"]
    np.testing.assert_allclose(got["test"]["loss"], one["loss"], rtol=1e-5)
    assert printed0.count("wer=") == 1 and printed1 == ""


def test_inference_host_devices_start_ranks(monkeypatch):
    """--host_devices N (and --platform cpu --gpus N) start N CPU ranks
    for inference, whose rank 0's results the CLI returns."""
    from tpu_asr_torch.cli import asr_inference
    from tpu_asr_torch.parallel import launch

    seen = []
    monkeypatch.setattr(launch, "launch", lambda fn, args, devices, **kw:
                        seen.append((fn.__name__, devices)) or ["rank 0"])
    for flags in (["--host_devices", "2"], ["--gpus", "3"]):
        assert asr_inference.main(["--platform", "cpu", "--ckpt_path", "x",
                                   "--test_manifest", "t.jsonl"]
                                  + flags) == "rank 0"
    assert seen == [("run_inference", ["cpu"] * 2),
                    ("run_inference", ["cpu"] * 3)]


@pytest.mark.parametrize("dp_size,world,refused", [
    (-1, 2, False), (2, 2, False), (1, 2, True), (4, 2, True)])
def test_trainer_dp_size_against_the_world(monkeypatch, dp_size, world,
                                           refused):
    from tpu_asr_torch.train.loop import refusals

    monkeypatch.setattr(mesh, "process_count", lambda: world)
    assert bool(refusals(PC.TrainConfig(dp_size=dp_size))) == refused
    # tensor parallelism: tp_size must divide the world
    assert not refusals(PC.TrainConfig(dp_size=-1, tp_size=2))
    assert refusals(PC.TrainConfig(dp_size=-1, tp_size=3))


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
