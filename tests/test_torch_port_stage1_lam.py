"""The port's Stage-I LAM training against the JAX package's.

``egot2x_torch`` ``LookingAtMe`` on ``BaselineLSTM`` against ``egot2x``'s
own task: its ``build_state`` (``optax.adam``) and its jitted
``train_step``, from the same weights (the port task's seeded ones, JAX
layout through the weight bridge) on the same batches of B=2 clips of
T=7 frames at 32^2, class weights [0.136, 0.864] (run_lam's), f32 on the
CPU. Both run their BNs on batch statistics and update the running ones
(flax's momentum 0.9, biased variance). JAX's gradient is the one its
``train_step`` hands the optimizer, taken with an optimizer that keeps it
(``capture_grads``); its Adam then runs over a packed tree
(``PackedAdam``).

Tolerances: loss rtol 1e-5; first-step gradients of every leaf rtol 1e-4,
atol 1e-6, and of the ResNet-18's by leaf norm, 1e-4 relative (plus that
atol over the leaf: ``check_step``, ``TRUNK_RTOL``); running statistics
after the step to 1e-5 of each layer's largest; parameters after 2 Adam
steps atol 1e-6, JAX's ``apply_gradients`` taking the port's gradients
each step (Adam's first steps scale g by lr / (|g| + eps), which turns a
1e-8 difference in a near-zero element into 1e-6 of a parameter: the
optimizer's conditioning, not the packages'); eval forwards rtol = atol =
1e-4; validation metrics 1e-6.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import egot2x.models.lam  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.tasks.lam import LookingAtMe as JaxLookingAtMe  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.tasks.lam import LookingAtMe  # noqa: E402
from test_torch_port_train import (PackedAdam, _as_jax,  # noqa: E402
                                   _leaves, _one_thread, capture_grads)

B, T, IMG = 2, 7, 32
WEIGHTS = [0.136, 0.864]
LR, SEED = 5e-4, 1
# the convolutional trunks' leaves by norm: measured 2.2e-5 at most here,
# where the port's and JAX's f32 steps are each 1.1-1.4e-5 from the port's
# f64 step (a batch-statistics BN's gradient subtracts its mean and
# projection terms, which cancel most of each element)
TRUNK_RTOL = 1e-4


def jax_step_task(jax_cls, cfg, variables, apply, **attrs):
    """The JAX task made without its constructor (which loads data): its
    model's ``init`` gives ``variables``, its ``apply`` is ``apply``."""
    task = object.__new__(jax_cls)
    task.cfg = cfg
    task.model = SimpleNamespace(init=lambda *a, **k: variables, apply=apply)
    for k, v in attrs.items():
        setattr(task, k, v)
    return task


def step_oracle(task, state, jax_task, batches):
    """The port task's ``train_step`` on ``batches`` (numpy dicts) from
    ``state``, and the JAX task's own jitted ``train_step`` on the
    first from the same weights (its gradient kept by ``capture_grads``);
    then the JAX task's optimizer (``PackedAdam``) on the port's gradients
    of each step. Everything in the JAX layout."""
    model = task.model
    variables = bridge.to_jax_variables(model)
    jstate0 = jax_task.build_state(jax.random.key(0))
    jstate, jmetrics = jax.jit(jax_task.train_step)(
        capture_grads(jstate0),
        {k: jnp.asarray(v) for k, v in batches[0].items()},
        jax.random.key(1))
    jax_grads = jstate.opt_state
    shadow = copy.deepcopy(model)
    steps = []
    for batch in batches:
        state, metrics = task.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator())
        steps.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=_as_jax(shadow, {n: p.grad.clone() for n, p in
                                   model.named_parameters()
                                   if p.grad is not None}),
            stats=bridge.to_jax_variables(model)["batch_stats"]))
    adam = PackedAdam(jstate0.params, jstate0.tx)
    for step in steps:
        adam.apply(step["grads"])
    return dict(
        state=state, variables=variables, steps=steps,
        metrics=steps[0]["metrics"],
        jax_metrics={k: float(v) for k, v in jmetrics.items()},
        grads=_leaves(steps[0]["grads"]), jax_grads=_leaves(jax_grads),
        stats=_leaves(steps[0]["stats"]),
        jax_stats=_leaves(jstate.batch_stats),
        params=_leaves(bridge.to_jax_variables(model)["params"]),
        jax_params=_leaves(adam.params()))


def check_step(oracle, trunks, trunk_rtol=TRUNK_RTOL, leaf_cosine=None):
    """The loss (rtol 1e-5) and every first-step gradient leaf: rtol 1e-4,
    atol 1e-6 element by element outside the JAX paths ``trunks`` (the
    convolutional trunks). A trunk's leaves: each by its norm,
    |g - g_jax| <= trunk_rtol |g_jax| + 1e-6 sqrt(size); or, where a ReLU
    input lands within f32 rounding of 0 (``leaf_cosine`` given), the
    trunk's leaves together by their norm at ``trunk_rtol`` and each leaf
    above that atol at cosine >= ``leaf_cosine`` (a flipped ReLU moves
    every leaf below it through the batch-statistics BNs' backward; a
    gradient routed wrong is off by O(1)); the other leaves then by their
    norm at 1e-4 (plus that atol), since the trunks' outputs carry the
    flip forward into the head. Returns the readings: each trunk's
    relative gap (whole, and its worst leaf) and least cosine, and the
    other leaves' relative gap in the second case."""
    np.testing.assert_allclose(oracle["metrics"]["loss"],
                               oracle["jax_metrics"]["loss"], rtol=1e-5)
    grads, jax_grads = oracle["grads"], oracle["jax_grads"]
    assert sorted(grads) == sorted(jax_grads)
    readings = {}
    for trunk in trunks:
        names = [n for n in jax_grads if n.startswith(trunk)]
        assert names, trunk
        gap = np.sqrt(sum(np.sum((grads[n] - jax_grads[n]) ** 2)
                          for n in names))
        norm = np.sqrt(sum(np.sum(jax_grads[n] ** 2) for n in names))
        worst, cosine = 0.0, 1.0
        for n in names:
            g, want = grads[n], jax_grads[n]
            err, floor = np.linalg.norm(g - want), 1e-6 * np.sqrt(g.size)
            if leaf_cosine is None:
                assert err <= trunk_rtol * np.linalg.norm(want) + floor, (
                    n, err, np.linalg.norm(want))
            elif err > floor:
                cos = float(g.ravel() @ want.ravel()) / (
                    np.linalg.norm(g) * np.linalg.norm(want))
                assert cos >= leaf_cosine, (n, cos)
                cosine = min(cosine, cos)
            if err > floor:
                worst = max(worst, err / np.linalg.norm(want))
        assert gap <= trunk_rtol * norm, (trunk, gap / norm)
        readings[trunk] = dict(whole=gap / norm, worst_leaf=worst,
                               least_cosine=cosine)
    for name, g in jax_grads.items():
        if any(name.startswith(t) for t in trunks):
            continue
        if leaf_cosine is None:
            np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        else:   # the trunks' outputs carry the flip into the head's inputs
            err = np.linalg.norm(grads[name] - g)
            assert err <= 1e-4 * np.linalg.norm(g) + 1e-6 * np.sqrt(
                g.size), (name, err, np.linalg.norm(g))
            readings[name] = err / np.linalg.norm(g)
    return readings


def check_statistics(oracle):
    """Every running mean and variance after the first step, to 1e-5 of
    the statistic's largest magnitude in its layer (a batch mean near 0
    carries the f32 rounding of the activations it averages, ~1e-7
    absolute at this batch)."""
    stats, jax_stats = oracle["stats"], oracle["jax_stats"]
    assert sorted(stats) == sorted(jax_stats) and stats
    for name, want in jax_stats.items():
        np.testing.assert_allclose(stats[name], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def check_adam(oracle):
    params, jax_params = oracle["params"], oracle["jax_params"]
    assert sorted(params) == sorted(jax_params)
    for name, want in jax_params.items():
        np.testing.assert_allclose(params[name], want, rtol=0, atol=1e-6,
                                   err_msg=name)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        frames=rng.standard_normal((B, T, IMG, IMG, 3)).astype(np.float32),
        label=rng.integers(0, 2, B).astype(np.int32))


def _cfg(model="BaselineLSTM"):
    return Config(model=model, weights=WEIGHTS, lr=LR, img_size=IMG)


@pytest.fixture(scope="module")
def lam():
    task = LookingAtMe(_cfg(), device="cpu")
    state = task.build_state(SEED)
    snapshot = {k: v.clone() for k, v in task.model.state_dict().items()}
    variables = bridge.to_jax_variables(task.model)
    jax_model = jax_build("BaselineLSTM")
    jax_task = jax_step_task(JaxLookingAtMe, task.cfg, variables,
                             jax_model.apply,
                             class_weights=np.asarray(WEIGHTS, np.float32))
    oracle = step_oracle(task, state, jax_task, [_batch(10), _batch(11)])
    eval_fn = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))
    return dict(task=task, oracle=oracle, snapshot=snapshot,
                eval_fn=eval_fn)


def test_lam_step_loss_and_gradients_match_jax(lam):
    assert np.isfinite(lam["oracle"]["metrics"]["loss"])
    check_step(lam["oracle"], ["['trunk']['base_model']"])


def test_lam_step_statistics_match_jax(lam):
    """Every BN's running mean and variance after the step (the stem's and
    the blocks'): flax's momentum and biased variance."""
    check_statistics(lam["oracle"])


def test_lam_adam_steps_match_jax(lam):
    """Every parameter after 2 steps; Adam holds every leaf."""
    check_adam(lam["oracle"])
    assert lam["oracle"]["state"].step == 2
    held = sum(len(g["params"])
               for g in lam["oracle"]["state"].optimizer.param_groups)
    assert held == len(list(lam["task"].model.parameters()))


@pytest.mark.parametrize("name", ["BaselineLSTM", "GazeLSTM"])
def test_lam_eval_forward_matches_jax(lam, name):
    task = LookingAtMe(_cfg(name), device="cpu")
    task.model.load_state_dict(lam["snapshot"])
    variables = bridge.to_jax_variables(task.model)
    frames = _batch(12)["frames"]
    with torch.no_grad():
        got = task.model.eval()(torch.from_numpy(frames))
    jax_model = jax_build(name)
    want = (lam["eval_fn"](variables, frames) if name == "BaselineLSTM"
            else jax.jit(lambda v, x: jax_model.apply(v, x))(variables,
                                                              frames))
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_gaze_lstm_trains_as_baseline_lstm(lam):
    """GazeLSTM is BaselineLSTM's graph: its step from the same weights
    is the same step, bit for bit."""
    losses, grads = [], []
    for name in ("BaselineLSTM", "GazeLSTM"):
        task = LookingAtMe(_cfg(name), device="cpu")
        state = task.build_state(SEED)
        task.model.load_state_dict(lam["snapshot"])
        state, metrics = task.train_step(
            state, {k: torch.from_numpy(v) for k, v in _batch(13).items()},
            torch.Generator())
        losses.append(metrics["loss"])
        grads.append([p.grad for p in task.model.parameters()])
    assert torch.equal(*losses)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_lam_validation_matches_jax(lam):
    """eval_step, accumulate (with a padding row) and finalize against the
    JAX task's, on the trained weights."""
    task = lam["task"]
    variables = bridge.to_jax_variables(task.model)
    jax_task = object.__new__(JaxLookingAtMe)
    jax_state = SimpleNamespace(
        apply_fn=lambda v, x, train=False: lam["eval_fn"](v, x),
        variables=lambda: variables)
    ctx, jax_ctx = task.start_validation(), jax_task.start_validation()
    for i, seed in enumerate((14, 15, 16)):
        batch = dict(_batch(seed), uid=[f"clip{seed}_{j}" for j in range(B)])
        if i == 2:
            batch["valid"] = np.array([True, False])
        got = task.eval_step(lam["oracle"]["state"], {
            k: torch.from_numpy(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)})
        want = jax_task.eval_step(jax_state, {"frames": batch["frames"]})
        np.testing.assert_allclose(got["scores"].numpy(),
                                   np.asarray(want["scores"]), rtol=1e-4,
                                   atol=1e-5)
        task.accumulate(ctx, got, batch)
        jax_task.accumulate(jax_ctx, want, batch)
    assert ctx["uids"] == jax_ctx["uids"] and len(ctx["uids"]) == 5
    assert ctx["labels"] == jax_ctx["labels"]
    got, want = task.finalize_validation(ctx), \
        jax_task.finalize_validation(jax_ctx)
    assert sorted(got) == sorted(want) == ["val_acc", "val_mAP"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    assert task.checkpoint_metric == "val_mAP"
    assert task.checkpoint_mode == "max"
