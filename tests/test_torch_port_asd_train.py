"""The port's ASD 2-loader training step against the JAX task's.

``egot2x_torch`` ``ActiveSpeakerDetection2Loader`` on
``TaskFusionMFTransformer3TaskASD`` behind the lossAV head, frozen and
``nofreeze``, against ``egot2x``'s own task: its ``build_state`` (the
frozen split, ``optax.adam``) and its jitted ``train_step``, with dropout
off (the translator's trunks run ``train=False`` always, so ``train``
only switches dropout), at the golden shapes of
tests/test_torch_port_train.py (B=2, T=4, IMG=64, D=64, 1 layer, 4
heads), the same seeded weights (JAX layout through the weight bridge)
and the same batch, f32 on the CPU. JAX's gradient is read from Adam's
first moment after its step, mu = (1 - 0.9) g.

Tolerances: loss rtol 1e-5 and frame accuracy equal; gradients rtol 1e-4
/ atol 1e-6 element by element for every leaf outside the trunks, and
for the trunks' leaves (``nofreeze``) by leaf norm, |g - g_jax| <=
TRUNK_RTOL |g_jax| + 1e-6 sqrt(size). The trunks' bound is looser because
this batch puts a ReLU input of the LAM trunk within f32 rounding of
zero: the port's f32 forward rounds it to the other side of the kink
than an f64 forward and the JAX f32 forward do, which moves the LAM
leaves below it by up to 4.9e-3 of their norm and TalkNet's by up to
4.0e-4 (readings in PERF.md, on one thread; the port's f64 step agrees
with JAX's to 1.5e-6). A gradient routed wrong moves a leaf by O(1).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.translate.egot2s_hhi  # noqa: E402,F401
from egot2x.tasks.asd_2loader import (  # noqa: E402
    ActiveSpeakerDetection2Loader as JaxASD2, _TranslatorWithHead as JaxTWH)
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.tasks.asd_2loader import (  # noqa: E402
    ActiveSpeakerDetection2Loader)
from egot2x_torch.translate.egot2s_hhi import FROZEN_KEYS  # noqa: E402
from test_torch_port_train import (_as_jax, _leaves,  # noqa: E402
                                   _no_dropout)

D, HEADS, LAYERS = 64, 4, 1
B, T, IMG = 2, 4, 64
LR, SEED = 1e-3, 1
TRUNK_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch's CPU ops on one intra-op thread while this module runs: the
    tier-1 suite runs six test processes on the machine's cores, and each
    process's default pool of one thread a core oversubscribes them (this
    module's steps ran ~100x slower there); alone, one thread costs them
    little. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        frames=rng.standard_normal((B, T, IMG, IMG, 3)).astype(np.float32),
        faces=rng.uniform(0, 255, (B, T, 112, 112)).astype(np.float32),
        audio=np.zeros((B, T * 16000 // 30), np.float32),
        mfcc=rng.standard_normal((B, 4 * T, 13)).astype(np.float32),
        labels=rng.integers(0, 2, (B, T)).astype(np.int32))


def _deterministic(jax_model):
    """The JAX model's apply with dropout off."""
    def apply(variables, *args, train=False, **kwargs):
        return jax_model.apply(variables, *args, train=False, **kwargs)
    return apply


def _in_trunk(key):
    return any(f"['{k}']" in key for k in FROZEN_KEYS)


@pytest.fixture(scope="module", params=[False, True],
                ids=["frozen", "nofreeze"])
def asd_step(request):
    """One step of the port task and of the JAX task from the same
    weights on the same batch."""
    nofreeze = request.param
    cfg = Config(model="TaskFusionMFTransformer3TaskASD", hidden_dim=D,
                 num_layers=LAYERS, num_heads=HEADS, dropout=0.0, lr=LR,
                 nofreeze=nofreeze)
    task = ActiveSpeakerDetection2Loader(cfg, device="cpu")
    state = task.build_state(SEED)
    model = _no_dropout(task.model)
    variables = bridge.to_jax_variables(model)
    stats = {k: v.clone() for k, v in model.named_buffers()
             if k.split(".")[1] in FROZEN_KEYS}
    jax_model = JaxTWH(model_name=cfg.model, hidden_dim=D,
                       num_layers=LAYERS, num_heads=HEADS, dropout=0.0,
                       nofreeze=nofreeze)
    jax_task = object.__new__(JaxASD2)   # its constructor loads no data
    jax_task.cfg = cfg
    jax_task.model = SimpleNamespace(init=lambda *a, **k: variables,
                                     apply=_deterministic(jax_model))
    jstate = jax_task.build_state(jax.random.key(0))
    batch = _batch(40)
    jstate, jmetrics = jax.jit(jax_task.train_step)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(1))
    jax_grads = jax.tree_util.tree_map(lambda m: m / (1 - 0.9),
                                       jstate.opt_state[0].mu)
    state, metrics = task.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator())
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    return dict(nofreeze=nofreeze, task=task, state=state, stats=stats,
                metrics={k: float(v) for k, v in metrics.items()},
                jax_metrics={k: float(v) for k, v in jmetrics.items()},
                grads=_leaves(_as_jax(copy.deepcopy(model), grads)),
                jax_grads=_leaves(jax_grads))


def test_asd2_step_matches_jax(asd_step):
    ours, theirs = asd_step["metrics"], asd_step["jax_metrics"]
    assert sorted(ours) == sorted(theirs) == ["acc", "loss"]
    assert np.isfinite(ours["loss"])
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-5)
    assert ours["acc"] == theirs["acc"]


def test_asd2_gradients_match_jax(asd_step):
    """Every trainable leaf's gradient: with ``nofreeze`` the trunks'
    too (by leaf norm); frozen, the translator's core and the lossAV head
    only."""
    grads, jax_grads = asd_step["grads"], asd_step["jax_grads"]
    assert sorted(grads) == sorted(jax_grads)
    trunks = [k for k in jax_grads if _in_trunk(k)]
    assert (len(trunks) > 100) is asd_step["nofreeze"]
    for name, g in jax_grads.items():
        if _in_trunk(name):
            err = np.linalg.norm(grads[name] - g)
            assert err <= TRUNK_RTOL * np.linalg.norm(g) + 1e-6 * np.sqrt(
                g.size), (name, err, np.linalg.norm(g))
        else:
            np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def test_asd2_split_and_statistics(asd_step):
    """Adam holds the translator less its frozen trunks (all of it with
    ``nofreeze``) and the lossAV head, with no weight decay; the trunks'
    BN statistics stay bit for bit; the task ranks checkpoints by
    ``val_acc``, higher first."""
    task, state = asd_step["task"], asd_step["state"]
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in task.model.named_parameters():
        frozen = (not asd_step["nofreeze"]
                  and name.split(".")[1] in FROZEN_KEYS)
        assert (id(p) in held) is not frozen, name
        assert p.requires_grad is not frozen, name
    assert all(g["weight_decay"] == 0.0
               for g in state.optimizer.param_groups)
    after = task.model.state_dict()
    assert len(asd_step["stats"]) > 100
    assert all(torch.equal(after[k], v) for k, v in asd_step["stats"].items())
    assert (task.checkpoint_metric, task.checkpoint_mode) == ("val_acc",
                                                              "max")
