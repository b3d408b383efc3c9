"""The port's ASD path against the JAX package, on the CPU.

Stage I: ``TalkNetWithHeads`` on two tracks of T = 8 frames of 112^2 (the
size of tests/test_asd.py's full-model test), all three logits. Stage II: the ASD
translators behind the lossAV head (``_TranslatorWithHead``:
``TaskFusionMFTransformer3TaskASD``, ``FinetuneASD``, ``LAM2ASD``,
``TTM2ASD``) at the golden shapes of tests/test_torch_import_asd3task.py
(B 2, T 4, RGB 64^2, hidden 64, 1 layer, 4 heads). Same weights (numpy,
JAX layout, through the weight bridge) and inputs on both sides, f32 with
full-precision matmuls, the JAX side jitted: logits agree to rtol = atol =
1e-4. The task layer's loss and its eval outputs (correct, total, scores;
val_acc over the valid tracks) equal the JAX task's on the same logits.
The bridge maps each new model's tree both ways exactly, and its random
tree has the structure of the JAX model's own.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.models.asd  # noqa: E402,F401  (registers)
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.tasks.asd import ActiveSpeakerDetection as JaxASD  # noqa: E402
from egot2x.tasks.asd import frame_weighted_ce as jax_ce  # noqa: E402
from egot2x.tasks.asd_2loader import (  # noqa: E402
    ActiveSpeakerDetection2Loader as JaxASD2, _TranslatorWithHead as JaxTWH)
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.tasks import asd, asd_2loader  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-4)
T_ASD = 8                       # Stage I: frames of one track
B, T, IMG, D = 2, 4, 64, 64     # Stage II golden shapes
TRANSLATORS = ["TaskFusionMFTransformer3TaskASD", "FinetuneASD", "LAM2ASD",
               "TTM2ASD"]


def _structure(tree):
    return sorted((jax.tree_util.keystr(p), np.shape(v)) for p, v in
                  jax.tree_util.tree_leaves_with_path(tree))


def _stage1_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return dict(mfcc=rng.standard_normal((b, 4 * T_ASD, 13)).astype(np.float32),
                faces=rng.uniform(0, 255, (b, T_ASD, 112, 112))
                .astype(np.float32),
                labels=rng.integers(0, 2, (b, T_ASD)))


def _stage2_batch(seed):
    rng = np.random.default_rng(seed)
    return dict(frames=rng.standard_normal((B, T, IMG, IMG, 3))
                .astype(np.float32),
                faces=rng.uniform(0, 255, (B, T, 112, 112)).astype(np.float32),
                audio=np.zeros((B, T * 16000 // 30), np.float32),
                mfcc=rng.standard_normal((B, 4 * T, 13)).astype(np.float32),
                labels=rng.integers(0, 2, (B, T)))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def stage1():
    """(port model, JAX variables, jitted JAX apply)."""
    port = build_model("TalkNetWithHeads", device="cpu")
    variables = bridge.random_jax_variables(port, seed=1)
    bridge.load_jax_variables(port, variables)
    apply = jax.jit(jax_build("TalkNetWithHeads").apply,
                    static_argnames=("train",))
    return port, variables, apply


def test_talknet_with_heads_matches_jax(stage1):
    port, variables, apply = stage1
    x = _stage1_batch(2)
    # train=False as the JAX task passes it: one compile for both tests
    ours = apply(variables, jnp.asarray(x["mfcc"]), jnp.asarray(x["faces"]),
                 train=False)
    with torch.no_grad():
        theirs = port(torch.from_numpy(x["mfcc"]), torch.from_numpy(x["faces"]))
    assert sorted(theirs) == sorted(ours)
    for name, got in theirs.items():
        assert got.shape == (2, T_ASD, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ours[name]), **TOL)


def test_frame_weighted_ce_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (3, 7))
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                  asd.ASD_CLASS_WEIGHTS)
    got = asd.frame_weighted_ce(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                asd.ASD_CLASS_WEIGHTS)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert asd.ASD_BUCKETS == (15, 30, 60, 90, 120, 150)


def _check_eval(port_task, jax_cls, jax_state, batch, port_state):
    """The port task's eval outputs and val_acc against the JAX task's
    (made without its constructor, which loads data; its eval methods read
    only the state and the batch). ``port_state``: the state the port
    task's ``eval_step`` takes."""
    jax_task = object.__new__(jax_cls)
    want = jax_task.eval_step(jax_state, _jax_batch(batch))
    got = port_task.eval_step(port_state, _torch_batch(batch))
    for key in ("correct", "total"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), **TOL)
    ctx_port, ctx_jax = port_task.start_validation(), \
        jax_task.start_validation()
    valid = np.arange(len(batch["labels"])) == 0
    for b in (batch, dict(batch, valid=valid)):
        port_task.accumulate(ctx_port, got, b)
        jax_task.accumulate(ctx_jax, want, b)
    assert ctx_port == ctx_jax
    assert port_task.finalize_validation(ctx_port) == \
        jax_task.finalize_validation(ctx_jax)


def test_eval_step_matches_jax(stage1):
    port, variables, apply = stage1
    state = SimpleNamespace(apply_fn=apply, variables=lambda: variables)
    task = asd.ActiveSpeakerDetection(Config(lr=1e-4), device="cpu")
    _check_eval(task, JaxASD, state, _stage1_batch(4),
                port_state=SimpleNamespace(model=port))


STAGE2_INPUTS = ("frames", "faces", "audio", "mfcc")


@pytest.fixture(scope="module", params=TRANSLATORS)
def stage2(request):
    """(JAX model, port _TranslatorWithHead, JAX variables, jitted JAX
    apply)."""
    port = asd_2loader.build_translator_with_head(
        request.param, device="cpu", hidden_dim=D)
    variables = bridge.random_jax_variables(port, seed=5)
    bridge.load_jax_variables(port, variables)
    model = JaxTWH(model_name=request.param, hidden_dim=D)
    return (model, port, variables,
            jax.jit(model.apply, static_argnames=("train",)))


def test_asd_translator_matches_jax(stage2):
    _, port, variables, apply = stage2
    x = _stage2_batch(6)
    ours = apply(variables, *(jnp.asarray(x[k]) for k in STAGE2_INPUTS),
                 train=False)
    with torch.no_grad():
        theirs = port(*(torch.from_numpy(x[k]) for k in STAGE2_INPUTS))
    assert theirs.shape == (B * T, 2)
    np.testing.assert_allclose(theirs.numpy(), np.asarray(ours), **TOL)
    state = SimpleNamespace(apply_fn=apply, frozen={},
                            params=variables["params"],
                            batch_stats=variables["batch_stats"])
    # the port task likewise without its constructor, which builds a model
    task = object.__new__(asd_2loader.ActiveSpeakerDetection2Loader)
    _check_eval(task, JaxASD2, state, x, SimpleNamespace(model=port))


def _assert_round_trip(port, variables, jax_model, *args):
    """The random tree has the JAX model's structure, and JAX tree ->
    port -> JAX tree gives it back leaf for leaf."""
    init = jax.eval_shape(lambda: jax_model.init(jax.random.key(0), *args))
    for coll in ("params", "batch_stats"):
        assert _structure(variables[coll]) == _structure(init[coll])
    back = bridge.to_jax_variables(bridge.load_jax_variables(port, variables))
    for coll in ("params", "batch_stats"):
        got = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        want = dict(jax.tree_util.tree_leaves_with_path(variables[coll]))
        assert got.keys() == want.keys()
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf)


def _stage1_args():
    return jnp.zeros((1, 4 * T_ASD, 13)), jnp.zeros((1, T_ASD, 112, 112))


def test_talknet_with_heads_bridge_round_trip(stage1):
    port, variables, _ = stage1
    _assert_round_trip(port, variables, jax_build("TalkNetWithHeads"),
                       *_stage1_args())


def test_talknet_backbone_bridge_round_trip():
    port = build_model("talkNetModel", device="cpu")
    _assert_round_trip(port, bridge.random_jax_variables(port, seed=7),
                       jax_build("talkNetModel"), *_stage1_args())


def test_asd_translator_bridge_round_trip(stage2):
    model, port, variables, _ = stage2
    x = _stage2_batch(0)
    _assert_round_trip(port, variables, model,
                       *(jnp.asarray(x[k]) for k in STAGE2_INPUTS))
