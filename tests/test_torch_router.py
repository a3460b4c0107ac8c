"""The port's dynamic step router (tpu_asr_torch/kd/router.py) against the
JAX package's on the CPU, weights carried by convert/from_jax.py, inputs
made with numpy from a seed:

- the deterministic parts at ordinary weights, for min_steps 1 and 3 and
  feature_reduce 'gap' and 'last', all L = 2 layers in one port call
  against one JAX call per layer: logits (the masked ones -inf in both),
  probs and expected steps at 1e-5, eval steps equal, eval loss 0; the
  entropy regulariser (training, budget off) and its gradients with
  respect to every parameter at 1e-5 relative;
- training under a margin: router_fc2 solved so that each (layer, sample)
  row puts a chosen count 60 above the rest (asserted > 21 on every row, so
  that no fp32 Gumbel draw, all within [-3.83, 16.64], moves the argmax),
  at least three distinct counts: the drawn steps equal JAX's and the loss
  (budget + entropy) at 1e-5;
- aggregate_steps against JAX's on ties, even batch sizes and halves
  (batch_mode: smallest of the tied counts; batch_avg: half to even;
  batch_median: lower middle), 'group' raises;
- the port's Gumbel draw alone: over 40000 rows of one set of logits the
  frequency of each drawn count is within 0.01 of softmax(logits) (about 6
  standard deviations of a frequency).
The whole model's eval forward with the router: test_torch_router_eval.py;
its whole KD steps: test_torch_router_{group,mode,avg,median}.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from tpu_asr.kd.router import DynamicStepRouter as JaxRouter
from tpu_asr.kd.router import aggregate_steps as jax_aggregate
from tpu_asr_torch.convert.from_jax import kd_to_state_dict
from tpu_asr_torch.kd.router import (DynamicStepRouter, aggregate_steps,
                                     gumbel_noise)

L, B, T, CS, CT, K = 2, 3, 7, 10, 14, 6


def _cfg(mod, **kw):
    kw = {"budget_target": 3.0, **kw}
    return mod.RouterConfig(max_steps=K, stu_dim=CS, tch_dim=CT,
                            hidden_dim=16, proj_dim=12, num_layers=L,
                            layer_emb_dim=6, entropy_weight=0.01,
                            budget_weight=0.05, **kw)


def _pair(seed, **kw):
    """(JAX router, params, port router, (L, B, T, C) student and teacher
    features)."""
    rng = np.random.default_rng(seed)
    stu = rng.normal(size=(L, B, T, CS)).astype(np.float32)
    tch = rng.normal(size=(L, B, T, CT)).astype(np.float32)
    jr = JaxRouter(_cfg(JC, **kw))
    v = jr.init({"params": jax.random.PRNGKey(seed),
                 "gumbel": jax.random.PRNGKey(0)}, jnp.asarray(stu[0]),
                jnp.asarray(tch[0]), 0)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.3 * rng.normal(
        size=a.shape).astype(np.float32), v["params"])
    pr = DynamicStepRouter(_cfg(PC, **kw))
    pr.load_state_dict(kd_to_state_dict(params), strict=True)
    return jr, params, pr, stu, tch


def _jax_layers(jr, params, stu, tch, train, key=None):
    """JAX's router per layer: (steps (L, B), summed loss, logits, probs,
    expected)."""
    outs = [jr.apply({"params": params}, jnp.asarray(stu[l]),
                     jnp.asarray(tch[l]), l, train=train,
                     rngs={"gumbel": jax.random.fold_in(key, l)}
                     if train else None) for l in range(L)]
    steps = np.stack([np.asarray(o[0]) for o in outs])
    aux = {k: np.stack([np.asarray(o[2][k]) for o in outs])
           for k in ("logits", "probs", "expected_steps")}
    return steps, sum(float(o[1]) for o in outs), aux


@pytest.mark.parametrize("reduce", ["gap", "last"])
@pytest.mark.parametrize("min_steps", [1, 3])
def test_router_matches_jax(min_steps, reduce):
    kw = dict(min_steps=min_steps, feature_reduce=reduce)
    jr, params, pr, stu, tch = _pair(min_steps, **kw)
    ids = torch.arange(L)
    want_steps, want_loss, want = _jax_layers(jr, params, stu, tch, False)
    with torch.no_grad():
        steps, loss, aux = pr(torch.from_numpy(stu), torch.from_numpy(tch),
                              ids)
    np.testing.assert_array_equal(steps.numpy(), want_steps)
    assert loss.item() == want_loss == 0.0
    finite = np.isfinite(want["logits"])
    assert finite.sum() == L * B * (K - min_steps + 1)
    np.testing.assert_array_equal(np.isfinite(aux["logits"].numpy()), finite)
    np.testing.assert_allclose(aux["logits"].numpy()[finite],
                               want["logits"][finite], rtol=1e-5, atol=1e-5)
    for name in ("probs", "expected_steps"):
        np.testing.assert_allclose(aux[name].numpy(), want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)

    # the entropy regulariser, budget off: deterministic, with gradients
    off = dict(kw, budget_target=None)
    jr_off = JaxRouter(_cfg(JC, **off))
    pr_off = DynamicStepRouter(_cfg(PC, **off))
    pr_off.load_state_dict(pr.state_dict())
    key = jax.random.PRNGKey(5)

    def jax_loss(p):
        return sum(jr_off.apply({"params": p}, jnp.asarray(stu[l]),
                                jnp.asarray(tch[l]), l, train=True,
                                rngs={"gumbel": key})[1] for l in range(L))

    want_l, want_g = jax.value_and_grad(jax_loss)(params)
    _, got_l, _ = pr_off(torch.from_numpy(stu), torch.from_numpy(tch), ids,
                         train=True, generator=torch.Generator())
    got_l.backward()
    np.testing.assert_allclose(got_l.item(), float(want_l), rtol=1e-5)
    want_sd = kd_to_state_dict(want_g)
    for name, p in pr_off.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=name)

    # training under a margin: the draw cannot move any row's argmax
    counts = (np.array([[1, 3, 6], [2, 5, 4]]) if min_steps == 1
              else np.array([[3, 4, 6], [5, 3, 4]]))
    with torch.no_grad():
        h = pr.hidden(torch.from_numpy(stu), torch.from_numpy(tch), ids)
    h_aug = torch.cat([h.reshape(L * B, -1),
                       torch.ones(L * B, 1)], 1).double()
    target = torch.zeros(L * B, K, dtype=torch.float64)
    target[torch.arange(L * B), torch.from_numpy(counts).reshape(-1) - 1] = 60
    w = (torch.linalg.pinv(h_aug) @ target).float()
    params = {**params, "router_fc2": {"kernel": w[:-1].numpy(),
                                       "bias": w[-1].numpy()}}
    pr.load_state_dict(kd_to_state_dict(params), strict=True)
    with torch.no_grad():
        logits = pr.logits(torch.from_numpy(stu), torch.from_numpy(tch), ids)
    top2 = logits.topk(2, dim=-1).values
    assert (top2[..., 0] - top2[..., 1]).min() > 21.0
    assert len(np.unique(counts)) >= 3
    want_steps, want_loss, _ = _jax_layers(jr, params, stu, tch, True,
                                           jax.random.PRNGKey(7))
    with torch.no_grad():
        steps, loss, _ = pr(torch.from_numpy(stu), torch.from_numpy(tch),
                            ids, train=True,
                            generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(want_steps, counts)
    np.testing.assert_array_equal(steps.numpy(), counts)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)


@pytest.mark.parametrize("strategy", ["batch_mode", "batch_avg",
                                      "batch_median"])
def test_aggregate_steps_matches_jax(strategy):
    for rows in ([[2, 2, 1, 1], [1, 4, 4, 2], [3, 1, 2, 4], [4, 4, 4, 4],
                  [1, 2, 3, 4], [6, 5, 5, 6]],
                 [[1, 2], [3, 4], [2, 2], [4, 1]],
                 [[1, 2, 2], [3, 1, 3], [5, 6, 1]]):
        steps = np.array(rows, np.int32)
        got = aggregate_steps(torch.from_numpy(steps), strategy, 6)
        want = [int(jax_aggregate(jnp.asarray(r), strategy, 6))
                for r in steps]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="Unknown router strategy"):
        aggregate_steps(torch.ones(2, 2, dtype=torch.int32), "group", 6)


def test_gumbel_frequencies_follow_softmax():
    logits = torch.tensor([0.5, -1.0, 2.0, 0.0, 1.0, -0.5])
    cfg = PC.RouterConfig(max_steps=K, stu_dim=CS, tch_dim=CT,
                          use_layer_id=False, budget_target=None,
                          entropy_weight=0.0)
    router = DynamicStepRouter(cfg)
    with torch.no_grad():
        router.router_fc2.weight.zero_()
        router.router_fc2.bias.copy_(logits)
    n = 40000
    with torch.no_grad():
        steps, loss, aux = router(torch.zeros(1, n, 1, CS),
                                  torch.zeros(1, n, 1, CT),
                                  torch.zeros(1, dtype=torch.long),
                                  train=True,
                                  generator=torch.Generator().manual_seed(0))
    assert loss.item() == 0.0
    freq = torch.bincount(steps.reshape(-1).long() - 1, minlength=K) / n
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits, 0).numpy(),
                               atol=0.01)
    g = gumbel_noise((n, K), torch.Generator().manual_seed(1), "cpu")
    assert torch.isfinite(g).all() and g.min() > -3.9 and g.max() < 16.7
