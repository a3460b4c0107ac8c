"""The port's data-parallel train step against JAX's, on the CPU: two gloo
ranks started by tpu_asr_torch/parallel/launch.py (spawn: this process has
JAX loaded), each holding 2 rows of a global batch of 4, take one step of
make_distil_train_step; JAX's loss and gradients of the same step
(jax.value_and_grad of the JAX DistilCTCModel's loss, which JAX's
make_distil_train_step differentiates) come from the global batch on one
device. The cases and sizes are those of tests/ddp_cases.py: CTC with
'mean_volume'; logit KD + FM with the mlp meta encoder; the router at
'batch_median' and at 'group', its counts fixed by a solved 60-logit margin
(tests/test_torch_kd_menu.py). Weights are made with numpy from a seed
(JAX's init traced, not run) and carried by convert/from_jax.

The halves of the batch differ (long, loud clips and long targets on rank
0, short ones on rank 1), so a mean of the ranks' means, BatchNorm
statistics of the local rows or local medians would fail. Losses at 1e-4
relative; gradients within 1e-5 + 1e-4 x the tensor's max|ref| (the
repo's rule, tests/test_torch_kd_menu.py: some gradients are zero in exact
arithmetic and their rounding noise is ~1e-6), equal on both ranks.

The other multi-process tests of the port are in tests/test_torch_ddp.py;
this one is apart so that each file stays under 30 s alone: its four JAX
programs compile here while the ranks run.
"""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_cases as C
import torch_ddp_ranks as R
import tpu_asr.config as JC
import tpu_asr_torch.config as PC
from test_torch_kd_menu import port_features, random_tree
from tpu_asr.models.distil_model import DistilCTCModel as JaxDistil
from tpu_asr_torch.convert.from_jax import KD_MODULES, distil_to_state_dict
from tpu_asr_torch.models.distil_model import DistilCTCModel
from tpu_asr_torch.parallel.launch import launch


@functools.lru_cache(maxsize=None)
def jax_params():
    """(params, batch_stats) of a JAX model holding the router and the FM:
    the shapes of its init (traced, not run) filled from a seed."""
    teacher, student, d = C.case_configs(JC, "router_group")
    jb = {k: jnp.asarray(v) for k, v in C.global_batch().items()}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        functools.partial(JaxDistil(student, teacher, d).init, train=True),
        {n: key for n in ("params", "specaug", "dropout", "gumbel",
                          "noise")}, jb["signal"], jb["signal_len"],
        jb["tokens"], jb["token_len"])
    return (random_tree(shapes["params"], 1),
            random_tree(shapes.get("batch_stats", {}), 2))


def case_weights(name):
    """(JAX params of the case's modules, batch_stats, port state_dict);
    the router's fc2 solved for STEPS at MARGIN."""
    full, stats = jax_params()
    teacher, student, d = C.case_configs(PC, name)
    model = DistilCTCModel(student, teacher, d)
    params = {"student": full["student"]}
    if model.needs_teacher:
        params["teacher"] = full["teacher"]
    params.update({k: full[k] for k in KD_MODULES if hasattr(model, k)})
    load = lambda p: model.load_state_dict(distil_to_state_dict(
        p, stats, student, teacher), strict=True)
    load(params)
    if model.routed:
        tb = {k: torch.from_numpy(v) for k, v in C.global_batch().items()}
        stu, tch = port_features(model, tb)
        ids = torch.arange(stu.shape[0])
        with torch.no_grad():
            h = model.router.hidden(stu, tch, ids).reshape(-1, 16).double()
        h_aug = torch.cat([h, torch.ones(h.shape[0], 1, dtype=h.dtype)], 1)
        target = torch.zeros(h.shape[0], C.K, dtype=h.dtype)
        target[torch.arange(h.shape[0]),
               torch.from_numpy(C.STEPS).reshape(-1) - 1] = C.MARGIN
        w = torch.linalg.pinv(h_aug) @ target
        params["router"] = {**params["router"], "router_fc2": {
            "kernel": w[:-1].float().numpy(), "bias": w[-1].float().numpy()}}
        load(params)
    return params, stats, model.state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch: a step of every case on 2 ranks, waited for in a thread
    while JAX's references compile here."""
    root = tmp_path_factory.mktemp("ddp_jax")
    jobs, weights, batch = [], {}, C.global_batch()
    for name in C.CASES:
        weights[name] = case_weights(name)
        sd = str(root / f"{name}.pt")
        torch.save(weights[name][2], sd)
        teacher, student, d = C.case_configs(PC, name)
        jobs.append(("run_steps", (student, teacher, d, sd, batch, 1)))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, R.run_jobs, (jobs,), ["cpu", "cpu"],
                            timeout=240, coll_timeout=120, threads=2)
        want = {name: C.jax_loss_and_grads(name, *weights[name][:2])
                for name in C.CASES}
        got = ranks.result()
    return {"ranks": got, "names": list(C.CASES), "weights": weights,
            "want": want}


@pytest.mark.parametrize("name", list(C.CASES))
def test_two_rank_step_matches_jax_at_the_global_batch(runs, name):
    i = runs["names"].index(name)
    two = [rank[i] for rank in runs["ranks"]]
    _, stats, _ = runs["weights"][name]
    want_losses, want_grads = runs["want"][name]
    got = two[0]["metrics"][0]
    assert two[1]["metrics"][0] == got
    assert set(want_losses) == {k[5:] for k in got if k.startswith("loss/")}
    for k, want in want_losses.items():
        np.testing.assert_allclose(got[f"loss/{k}"], float(want), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    teacher, student, _ = C.case_configs(PC, name)
    want_sd = distil_to_state_dict(want_grads, stats, student, teacher)
    assert set(two[0]["grads"]) == {k for k in want_sd if k in
                                    two[0]["state"] and not k.startswith(
                                        "teacher.") and "running" not in k
                                    and "num_batches" not in k}
    for k, g in two[0]["grads"].items():
        w = want_sd[k].numpy()
        np.testing.assert_array_equal(two[1]["grads"][k], g, err_msg=k)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=k)
    if "router" in C.CASES[name]:
        steps, margins = two[0]["router"][0]
        np.testing.assert_array_equal(steps, C.STEPS)
        assert margins.min() > 21.0
