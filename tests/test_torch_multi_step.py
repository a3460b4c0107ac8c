"""steps_per_dispatch and the teacher caches in the port's fit loop, on the
CPU (tpu_asr_torch/train/trainer.py make_distil_multi_step,
data/dataset.py stack_batches, train/loop.py):

- stack_batches groups the batches JAX's stack_batches groups, with the
  same stacked arrays (utt_idx too), texts and leftovers
  (JAX's tests/test_train.py:272 batches);
- the multi-step of K=3 equals 3 train_step calls on the same stacked
  batches, bit for bit (metrics, parameters, BatchNorm statistics, step),
  with dropout 0.1, SpecAugment and dither on: each step draws from (seed,
  state.step);
- (against JAX's make_distil_multi_step: tests/test_torch_multi_step_jax.py,
  apart so that each file runs alone in under 30 s);
- Trainer.fit of 2 epochs with cache_teacher (last layer, in RAM), with
  cache_teacher_all (every layer, one file a utterance) and with
  steps_per_dispatch=2 gives the losses of every step and the final
  weights of the fit without them, bit for bit (fp32: the stored features
  are the teacher's own), the cached step runs in epoch 2, and the cache
  holds every utterance.
"""


import tests.torch_threads  # noqa: F401  (first: CPU threads)
import numpy as np
import pytest
import torch

import tpu_asr_torch.config as PC
from tests.test_torch_fit import _rows, _trainer, corpus
from tests.test_torch_train import _batch, _configs, _distill
from tpu_asr.data.dataset import stack_batches as jax_stack_batches
from tpu_asr_torch.data.dataset import stack_batches
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.train.trainer import (DistilTrainState,
                                         make_distil_multi_step,
                                         make_distil_train_step)

OPTIM = dict(d_model=32, warmup_steps=10)


def test_stack_batches_equals_jax():
    def mk(shape, val):
        return {"signal": np.full(shape, val, np.float32),
                "utt_idx": np.full(shape[:1], val, np.int32),
                "texts": [f"t{val}"]}

    batches = [mk((2, 10), 0), mk((2, 10), 1), mk((2, 16), 2),
               mk((2, 10), 3), mk((2, 16), 4), mk((2, 10), 5),
               mk((2, 12), 6)]
    for k in (2, 3):
        for n in (7, 3):
            want = list(jax_stack_batches(
                iter([dict(b) for b in batches[:n]]), k))
            got = list(stack_batches(iter([dict(b) for b in batches[:n]]),
                                     k))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert set(g) == set(w) and g["texts"] == w["texts"]
                assert g.get("_steps") == w.get("_steps")
                for key in ("signal", "utt_idx"):
                    np.testing.assert_array_equal(g[key], w[key])
    stacked = [b for b in stack_batches(iter([dict(b) for b in batches]), 2)
               if b.get("_steps")]
    assert [b["utt_idx"][:, 0].tolist() for b in stacked] == [[0, 1], [2, 4],
                                                              [3, 5]]


def stacked_batches(k, seed=3):
    """k batches of _batch's shapes, signals drawn apart, stacked (k, ...)
    as numpy."""
    rng = np.random.default_rng(seed)
    one = _batch()
    return {n: (np.stack([v] * k) if n != "signal" else
                (rng.normal(size=(k,) + v.shape) * 0.1).astype(np.float32))
            for n, v in one.items()}


def test_multi_step_equals_sequential_steps():
    teacher, student = _configs(PC, dropout=0.1, spec=True, dither=1e-5)
    d = _distill(PC, "flowkd")
    torch.manual_seed(0)
    init = DistilCTCModel(student, teacher, d).state_dict()
    batches = {k: torch.from_numpy(v) for k, v in stacked_batches(3).items()}
    runs = []
    for multi in (False, True):
        model = DistilCTCModel(student, teacher, d)
        model.load_state_dict(init)
        state = DistilTrainState.create(model, PC.OptimConfig(**OPTIM))
        if multi:
            state, metrics = make_distil_multi_step(model)(state, batches, 7)
        else:
            step, per = make_distil_train_step(model), []
            for i in range(3):
                state, m = step(state, {k: v[i] for k, v in batches.items()},
                                7)
                per.append(m)
            metrics = {k: torch.stack([m[k] for m in per]) for k in per[0]}
        runs.append((state.step, metrics, model.state_dict()))
    (s1, m1, sd1), (s2, m2, sd2) = runs
    assert s1 == s2 == 3 and set(m1) == set(m2)
    for k in m1:
        assert m2[k].shape == (3,) and torch.equal(m1[k], m2[k]), k
    assert len(set(m1["loss/total"].tolist())) == 3
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Fits of 2 epochs (6 clips, batches of 3; logit KD + last-scope
    layerwise KD, dropout 0.1, SpecAugment, dither) without and with each
    option; (Trainer, metrics rows, cached steps run) by name."""
    root = tmp_path_factory.mktemp("fits")
    man, texts = corpus(root, n=6, seed=21, lo=0.6, hi=1.2)
    d = PC.DistillationConfig(use_logit_distillation=True,
                              use_layerwise_distillation=True,
                              layer_kd_scope="last")
    out = {}
    for name, kw in (("plain", {}), ("last", dict(cache_teacher=True)),
                     ("all", dict(cache_teacher_all=True,
                                  cache_teacher_dir=str(root / "tcache"))),
                     ("spd", dict(steps_per_dispatch=2))):
        tr = _trainer(man, texts, root / name, distill=d, **kw)
        n_cached = [0]
        if tr._cache is not None:
            cached = tr._train_step_cached

            def counting(*a, _f=cached, _n=n_cached):
                _n[0] += 1
                return _f(*a)

            tr._train_step_cached = counting
        tr.fit(man)
        out[name] = (tr, _rows(root / name / "metrics.jsonl"), n_cached[0])
    return root, out


@pytest.mark.parametrize("name", ["last", "all", "spd"])
def test_fit_with_option_equals_fit_without(fits, name):
    root, runs = fits
    base, base_rows, _ = runs["plain"]
    tr, rows, n_cached = runs[name]
    assert tr.state.step == base.state.step == 4
    by_step = lambda rs: {r["step"]: {k: v for k, v in r.items()
                                      if k.startswith("loss/")}
                          for r in rs if "loss/total" in r}
    got, want = by_step(rows), by_step(base_rows)
    # steps_per_dispatch logs the last step of each dispatch
    assert set(got) == ({2, 4} if name == "spd" else {1, 2, 3, 4})
    for s, r in got.items():
        assert r == want[s], s
    sd, base_sd = tr.model.state_dict(), base.model.state_dict()
    for k in base_sd:
        assert torch.equal(sd[k], base_sd[k]), k
    if name != "spd":
        assert n_cached == 2                    # epoch 2's two batches
        cache = tr._cache
        assert cache.has_all(range(6)) and cache.all_layers == (name == "all")
    if name == "all":
        files = sorted(p.name for p in (root / "tcache").iterdir())
        assert files == [f"{i}.npy" for i in range(6)]
        assert np.load(root / "tcache" / "0.npy").shape[:1] == (2,)
