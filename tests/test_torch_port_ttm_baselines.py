"""The port's TTM baselines against the JAX package.

``egot2x_torch`` ``FinetuneTTM``, ``LAM2TTM``, ``ASD2TTM`` and
``TaskFusionLFLinear3Task`` (``translate/egot2s_hhi.py``) against
``egot2x.translate.egot2s_hhi``'s, at the golden shapes of
tests/test_torch_port_train.py (B=2, T=4, RGB 64^2, grey faces 48^2,
MFCC; hidden 64, ``hidden_dim2`` 48), the same seeded weights (JAX layout
through the weight bridge) and the same inputs, f32 on the CPU, the JAX
side jitted: logits max |delta| <= 1e-4 (1 + |ref|). The late-fusion model
takes a uint8 RGB feed (normalised once in the port; the JAX trunks'
stems normalise it each).

One frozen train step of ``FinetuneTTM`` through ``TalkingToMe2Loader``
(its defaults: ``hidden_dim2`` 512, as the JAX task builds it) against
the JAX task's own jitted ``train_step``, its gradient kept by a
capturing optimizer (``capture_grads``): loss rtol 1e-5, the head's
gradients rtol 1e-4 / atol 1e-6, its parameters after Adam (the JAX
task's optimizer, ``PackedAdam``) atol 1e-6; the trunk's weights and BN
statistics bit for bit, with no gradient. Then ``run_ttm --two_loader
--model FinetuneTTM --synthetic --fast_dev_run --device cpu`` on the small
TTM tree of tests/test_torch_port_cli.py.
"""

import copy
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.translate.egot2s_hhi  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.tasks.ttm_2loader import (  # noqa: E402
    TalkingToMe2Loader as JaxTTM2)
from egot2x_torch.cli import run_ttm  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader  # noqa: E402
from test_torch_port_cli import workdir  # noqa: E402,F401
from test_torch_port_resnet3d import assert_close  # noqa: E402
from test_torch_port_train import (PackedAdam, _as_jax, _batch,  # noqa: E402
                                   _leaves, _one_thread, capture_grads)

D, D2 = 64, 48
WEIGHTS = [0.266, 0.734]
LR, WD, SEED = 1e-3, 1e-2, 2
INPUTS = ("frames", "video_asd", "audio", "audio_asd")
BASELINES = ("FinetuneTTM", "LAM2TTM", "ASD2TTM", "TaskFusionLFLinear3Task")


def _inputs(name):
    batch = _batch(20)
    if name == "TaskFusionLFLinear3Task":
        rng = np.random.default_rng(21)
        batch["frames"] = rng.integers(0, 256, batch["frames"].shape
                                       ).astype(np.uint8)
    return [batch[k] for k in INPUTS]


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_logits_match_jax(name):
    port = build_model(name, device="cpu", hidden_dim=D, hidden_dim2=D2)
    variables = bridge.random_jax_variables(port, SEED)
    bridge.load_jax_variables(port, variables)
    jax_model = jax_build(name, hidden_dim=D, hidden_dim2=D2)
    x = _inputs(name)
    want = np.asarray(jax.jit(jax_model.apply)(variables,
                                               *map(jnp.asarray, x)))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, x)).numpy()
    assert got.shape == (2, 2) and np.isfinite(got).all()
    assert_close(got, want)


def test_baselines_refuse_int8():
    with pytest.raises(ValueError, match="no int8 path"):
        build_model("FinetuneTTM", device="cpu", quant=True)


@pytest.fixture(scope="module")
def step():
    """One frozen step of the port task and of the JAX task from the same
    weights on the same batch."""
    cfg = Config(model="FinetuneTTM", weights=WEIGHTS, lr=LR, wd=WD,
                 img_size=64)
    task = TalkingToMe2Loader(cfg, device="cpu")
    state = task.build_state(SEED)
    model = task.model
    variables = bridge.to_jax_variables(model)
    trunk = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("ttm_model.")}
    jax_model = jax_build("FinetuneTTM")
    jax_task = object.__new__(JaxTTM2)   # its constructor loads no data
    jax_task.cfg = cfg
    jax_task.class_weights = np.asarray(WEIGHTS, np.float32)
    jax_task.model = SimpleNamespace(init=lambda *a, **k: variables,
                                     apply=jax_model.apply)
    jstate = jax_task.build_state(jax.random.key(0))
    adam = PackedAdam(jstate.params, jstate.tx)
    batch = _batch(30)
    jstate, jmetrics = jax.jit(jax_task.train_step)(
        capture_grads(jstate), {k: jnp.asarray(batch[k])
                                for k in INPUTS + ("label",)},
        jax.random.key(1))
    state, metrics = task.train_step(
        state, {k: torch.from_numpy(batch[k]) for k in INPUTS + ("label",)},
        torch.Generator())
    grads = _leaves(_as_jax(copy.deepcopy(model), {
        n: p.grad for n, p in model.named_parameters()
        if p.grad is not None}))
    adam.apply(_as_jax(copy.deepcopy(model), {
        n: p.grad for n, p in model.named_parameters()
        if p.grad is not None}))
    params = _leaves(_as_jax(copy.deepcopy(model), {
        n: p for n, p in model.named_parameters() if n.startswith("head.")}))
    return dict(model=model, trunk=trunk, loss=float(metrics["loss"]),
                jax_loss=float(jmetrics["loss"]), grads=grads,
                jax_grads=_leaves(jstate.opt_state), params=params,
                jax_params=_leaves(adam.params()))


def test_frozen_step_matches_jax(step):
    assert np.isfinite(step["loss"])
    np.testing.assert_allclose(step["loss"], step["jax_loss"], rtol=1e-5)
    assert sorted(step["grads"]) == sorted(step["jax_grads"])
    assert len(step["grads"]) == 6   # the head's fc1-fc3, nothing else
    for name, g in step["jax_grads"].items():
        np.testing.assert_allclose(step["grads"][name], g, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert sorted(step["params"]) == sorted(step["jax_params"])
    for name, want in step["jax_params"].items():
        np.testing.assert_allclose(step["params"][name], want, rtol=0,
                                   atol=1e-6, err_msg=name)


def test_frozen_step_keeps_the_trunk(step):
    after = step["model"].state_dict()
    assert len(step["trunk"]) > 100
    assert all(torch.equal(after[k], v) for k, v in step["trunk"].items())
    for name, p in step["model"].named_parameters():
        if name.startswith("ttm_model."):
            assert p.grad is None, name


def test_run_ttm_two_loader_finetune_ttm(workdir):  # noqa: F811
    metrics = run_ttm.main(["--two_loader", "--model", "FinetuneTTM",
                            "--synthetic", "--fast_dev_run", "--device",
                            "cpu", "--batch_size", "15", "--img_size", "32"])
    assert metrics and all(math.isfinite(v) for v in metrics.values())
