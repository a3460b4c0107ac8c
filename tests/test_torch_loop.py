"""The port's fit loop (tpu_asr_torch/train/loop.py) against JAX's Trainer
on the CPU.

`Trainer.fit` of a student (2 layers, d 32) from JAX's initial weights
(jax.eval_shape of the init filled with seeded numpy, carried by
convert/from_jax), dropout 0, no SpecAugment, no dither, `log_every=1`,
AdamW, three steps over two epochs of shuffled batches (six clips in one
duration bucket, batch 3), CTC only here and under logit KD in
test_torch_loop_kd.py:

- each step's logged losses within 1e-5 relative of JAX's metrics.jsonl;
- the port's own trained weights against JAX's. Adam divides each
  element's step by its gradient's RMS, so an element whose gradient is
  zero to rounding takes steps of either sign from the rounding noise: the
  key and depthwise-conv biases (a softmax over keys, and BatchNorm in
  training, cancel them exactly) and the position projection's weights on
  position features that are constant to rounding over one-second clips.
  The rule: an element is left out when its gradient RMS over the fit
  (from JAX's Adam second moment) is below 1e-4 of the whole student
  gradient's; the left-out elements are printed per tensor. Every other
  element's update (final - initial weights) agrees with JAX's within 1e-4
  in norm, tensor by tensor (the largest measured on the CPU is 3.8e-5,
  the subsampling's second conv); BatchNorm's running variances agree within
  1e-4 (the running means follow the depthwise bias); a frozen teacher
  ends bit-equal to where it began, in both;
- `evaluate` on the port's own weights, with only the left-out elements
  and the running means taken from JAX: the same WER and the loss within
  1e-5 of JAX's `evaluate`.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tpu_asr.data.tokenizer import train_bpe as jax_train_bpe
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr.parallel.mesh import replicated
from tpu_asr.train.loop import Trainer as JaxTrainer
from tpu_asr.train.optim import build_optimizer as jax_build_optimizer
from tpu_asr.train.trainer import DistilTrainState as JaxState
from test_torch_fit import configs, corpus, train_config
from tpu_asr_torch.convert.from_jax import distil_to_state_dict
from tpu_asr_torch.data.tokenizer import train_bpe
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.train.loop import Trainer

def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        n = rng.normal(size=a.shape).astype(np.float32)
        name = path[-1].key
        if name in ("scale", "var"):
            return 1.0 + np.float32(0.1) * np.abs(n)
        if name == "kernel":
            return n / np.float32(np.sqrt(np.prod(a.shape[:-1])))
        return np.float32(0.1) * n

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rows(path):
    return [json.loads(l) for l in open(path)]


def _grad_rms(opt_state, steps: int, b2: float, stats, pstudent, pteacher):
    """{port tensor name: per-element RMS of JAX's gradient over the fit}
    from the second moment of its Adam state."""
    adam = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    nu = dict(jax.device_get(adam[0].nu))
    nu.pop("teacher", None)
    sd = distil_to_state_dict(nu, stats, pstudent, pteacher)
    return {k: torch.sqrt(v.double() / (1 - b2 ** steps))
            for k, v in sd.items()}


def fit_both(tmp_path, distill):
    """JAX's and the port's fits of three steps from the same weights, and
    the checks of this module's docstring."""
    man, texts = corpus(tmp_path, lo=0.6, hi=1.0)
    tok, jtok = train_bpe(texts, 28), jax_train_bpe(texts, 28)

    teacher, student = configs(JC, tok.vocab_size)
    jmodel = JaxDistil(student, teacher, distill(JC))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(jmodel.init, train=True),
        {n: key for n in ("params", "specaug", "dropout", "gumbel",
                          "noise")},
        jnp.zeros((3, 48000)), jnp.full((3,), 48000, jnp.int32),
        jnp.zeros((3, 16), jnp.int32), jnp.full((3,), 4, jnp.int32))
    params = _random_tree(shapes["params"], 1)
    stats = _random_tree(shapes["batch_stats"], 2)
    cfg = train_config(JC, student, jmodel.distill)
    jtrainer = JaxTrainer(jmodel, cfg, jtok, tmp_path / "jax", log_every=1)
    jtrainer.state = jax.device_put(JaxState.create(
        apply_fn=jmodel.apply, params=params, batch_stats=stats,
        tx=jax_build_optimizer(cfg.optim, params)),
        replicated(jtrainer.mesh))
    jtrainer.fit(man, max_steps=3)
    want_eval = jtrainer.evaluate(man)

    pteacher, pstudent = configs(PC, tok.vocab_size)
    model = DistilCTCModel(pstudent, pteacher, distill(PC))
    init = distil_to_state_dict(params, stats, pstudent, pteacher)
    model.load_state_dict(init, strict=True)
    trainer = Trainer(model, train_config(PC, pstudent, model.distill), tok,
                      tmp_path / "port", log_every=1, device="cpu")
    trainer.fit(man, max_steps=3)

    want = _rows(tmp_path / "jax" / "metrics.jsonl")
    got = _rows(tmp_path / "port" / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        names = {k for k in w if k.startswith("loss/")}
        assert names == {k for k in g if k.startswith("loss/")}
        for k in names:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"step {w['step']} {k}")
        assert g["epoch"] == w["epoch"]

    jstats = jax.device_get(jtrainer.state.batch_stats)
    final = distil_to_state_dict(jax.device_get(jtrainer.state.params),
                                 jstats, pstudent, pteacher)
    rms = _grad_rms(jtrainer.state.opt_state, 3, cfg.optim.betas[1], jstats,
                    pstudent, pteacher)
    trained = [k for k, p in model.named_parameters() if p.requires_grad
               and not k.startswith("teacher.")]
    floor = 1e-4 * torch.sqrt(torch.cat(
        [rms[k].flatten() ** 2 for k in trained]).mean())
    mine = model.state_dict()
    left_out = {}
    for k in trained:
        keep = rms[k] >= floor
        if not keep.all():
            left_out[k] = f"{int((~keep).sum())}/{keep.numel()}"
        dj = (final[k].double() - init[k].double())[keep]
        dp = (mine[k].double() - init[k].double())[keep]
        err = float((dp - dj).norm() / dj.norm().clamp_min(1e-30))
        assert err <= 1e-4, (k, err)
    print(f"elements whose gradient is zero to rounding: {left_out}")
    for k in mine:
        if k.startswith("teacher."):    # frozen, statistics included
            assert torch.equal(mine[k], init[k]) and \
                torch.equal(final[k], init[k]), k
    for k in mine:
        if k.endswith("running_var"):
            np.testing.assert_allclose(mine[k], final[k], rtol=1e-4,
                                       err_msg=k)

    with torch.no_grad():
        for k in trained:
            keep = rms[k] >= floor
            mine[k].copy_(torch.where(keep, mine[k], final[k]))
        for k in mine:
            if k.endswith("running_mean"):
                mine[k].copy_(final[k])
    got_eval = trainer.evaluate(man)
    assert got_eval["wer"] == want_eval["wer"]
    assert got_eval["num_utts"] == want_eval["num_utts"] == 6
    np.testing.assert_allclose(got_eval["loss"], want_eval["loss"],
                               rtol=1e-5)
    return left_out


def cancelled(left_out) -> bool:
    """Whether every key and depthwise-conv bias was left out."""
    return all(left_out.get(f"student.encoder.layers.{i}.{name}") == "32/32"
               for i in (0, 1)
               for name in ("self_attn.linear_k.bias",
                            "conv.depthwise_conv.bias"))


def test_fit_and_evaluate_match_jax(tmp_path):
    assert cancelled(fit_both(tmp_path, lambda mod: mod.DistillationConfig()))
