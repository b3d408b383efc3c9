"""The port's EgoT2-g HHI Stage-II task against the JAX package's.

``egot2x_torch`` ``Unified3TaskTranslation`` (``TaskTranslationPrompt
Transformer``) against ``egot2x``'s own task: its ``build_state`` (the
frozen split, ``construct_optimizer("adam")``) and its jitted
``train_step``, with dropout off (the JAX model's
apply pinned to ``train=False``; the backbones run ``train=False`` always,
so ``train`` only switches dropout, which the PE's fixed 0.1 would keep on
in the JAX step), at hidden 32, 4 heads, 1 layer, vocab 7, on one
combined batch of LAM 2 clips x 7 frames, TTM and ASD 2 x 3 frames of
32^2 RGB, the same seeded weights (JAX layout through the weight bridge),
f32 on the CPU. tests/test_torch_port_egot2g_unified.py runs the same
tests on ``Unified3Task`` (``TaskPromptTransformer``), and
tests/test_torch_port_egot2g_eval.py holds both tasks' eval steps and
validation against the JAX task's.

Two steps on two batches. Each step the JAX task takes its step at the
port's parameters, and JAX's gradient is read from Adam's first moment
after it, mu_k = 0.9 mu_(k-1) + 0.1 g_k; then the JAX state goes on with
the port's gradient (``apply_gradients``), so that both stay on one
trajectory: Adam's first steps scale a gradient g by lr / (|g| + eps),
which turns a rounding difference in an element whose g is ~0 (k_proj's
bias, 0 in exact arithmetic) into one of ~lr in the parameter (see
tests/test_torch_port_train.py), and the ~1e-7 between the two Adams'
parameters would reach the second step's gradients.

Tolerances: loss rtol 1e-5; every trainable leaf's gradient rtol 1e-4,
atol 1e-6; the parameters after 2 Adam steps atol 1e-6; the frozen
backbones' weights and statistics bit for bit.
"""

import copy
import tempfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.tasks.multitask_hhi as jax_tasks  # noqa: E402
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.data.combined import CombinedLoader  # noqa: E402
from egot2x_torch.tasks import multitask_hhi  # noqa: E402
from egot2x_torch.train.trainer import Trainer  # noqa: E402
from egot2x_torch.translate.egot2g import FROZEN_KEYS  # noqa: E402
from test_torch_port_train import (_as_jax, _leaves,  # noqa: E402
                                   _no_dropout, _one_thread)

D, HEADS, LAYERS = 32, 4, 1
B, T, IMG, LAM_FRAMES = 2, 3, 32, 7
LR, SEED, STEPS = 1e-3, 1, 2
VOCAB = 7


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _target(rng, task_id, *shape):
    """[task token, '0' or '1', '</s>'] sequences, (*shape, 3)."""
    return np.stack([np.full(shape, task_id), 5 + rng.integers(0, 2, shape),
                     np.zeros(shape, np.int64)], axis=-1).astype(np.int32)


def _batches(seed):
    """One combined batch: {task: batch} as the JAX task's loaders give."""
    rng = np.random.default_rng(seed)
    wave = np.zeros((B, T * 16000 // 30), np.float32)
    return {
        "lam": dict(frames=_f32(rng, B, LAM_FRAMES, IMG, IMG, 3),
                    target_seq=_target(rng, 3, B)),
        "ttm": dict(frames=_f32(rng, B, T, IMG, IMG, 3),
                    video_asd=rng.uniform(0, 255, (B, T, 112, 112))
                    .astype(np.float32),
                    audio=wave, audio_asd=_f32(rng, B, 4 * T, 13),
                    target_seq=_target(rng, 2, B)),
        "asd": dict(frames=_f32(rng, B, T, IMG, IMG, 3),
                    faces=rng.uniform(0, 255, (B, T, 112, 112))
                    .astype(np.float32),
                    audio=wave, mfcc=_f32(rng, B, 4 * T, 13),
                    target_seq=_target(rng, 4, B, T))}


def _as(kind, batches):
    convert = torch.from_numpy if kind == "torch" else jnp.asarray
    return {t: {k: convert(v) for k, v in b.items()}
            for t, b in batches.items()}


def _deterministic(jax_model):
    """The JAX model's apply with dropout off (``predict`` takes no
    ``train``)."""
    def apply(variables, *args, **kwargs):
        if "method" not in kwargs:
            kwargs["train"] = False
        return jax_model.apply(variables, *args, **kwargs)
    return apply


def _adam_mu(opt_state):
    """The first moment of the optimizer state's Adam."""
    return next(s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))


def _cfg():
    return Config(hidden_dim=D, num_heads=HEADS, num_layers=LAYERS,
                  dropout=0.0, lr=LR, img_size=IMG)


def _tasks(task_name):
    """(the port task on the CPU, its state from ``build_state``, the JAX
    task with the same weights and its state from its ``build_state``),
    dropout off on both."""
    task = getattr(multitask_hhi, task_name)(_cfg(), device="cpu")
    state = task.build_state(SEED)
    variables = bridge.to_jax_variables(_no_dropout(task.model))
    jax_cls = getattr(jax_tasks, task_name)
    jax_model = jax_build(jax_cls.model_name, vocab_size=VOCAB,
                          hidden_dim=D, num_heads=HEADS, num_layers=LAYERS,
                          dropout=0.0)
    jax_task = object.__new__(jax_cls)   # its constructor builds loaders
    jax_task.cfg, jax_task.n_frames = _cfg(), T
    jax_task.model = SimpleNamespace(init=lambda *a, **k: variables,
                                     apply=_deterministic(jax_model))
    return task, state, jax_task, jax_task.build_state(jax.random.key(0))


@pytest.fixture(scope="module")
def task_name():
    """The task under test (tests/test_torch_port_egot2g_unified.py
    overrides it)."""
    return "Unified3TaskTranslation"


@pytest.fixture(scope="module")
def run(task_name):
    """STEPS train steps of the port task and of the JAX task from the
    same weights on the same batches."""
    task, state, jax_task, jstate = _tasks(task_name)
    model = task.model
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if k.split(".", 1)[0] in FROZEN_KEYS}
    jax_step = jax.jit(jax_task.train_step)
    follow = jax.jit(lambda js, grads: js.apply_gradients(grads))
    shadow = copy.deepcopy(model)
    generator = torch.Generator().manual_seed(0)
    steps = []
    trainable = lambda: _as_jax(shadow, {n: p for n, p in
                                         model.named_parameters()
                                         if p.requires_grad})
    for i in range(STEPS):
        batches = _batches(10 + i)
        # JAX's step at the port's parameters
        own, jmetrics = jax_step(jstate.replace(params=trainable()),
                                 _as("jax", batches), jax.random.key(i))
        jgrads = jax.tree_util.tree_map(
            lambda new, old: (new - 0.9 * old) / 0.1, _adam_mu(own.opt_state),
            _adam_mu(jstate.opt_state))
        state, metrics = task.train_step(state, _as("torch", batches),
                                         generator)
        grads = _as_jax(shadow, {n: p.grad for n, p in
                                 model.named_parameters()
                                 if p.grad is not None})
        jstate = follow(jstate, grads)
        steps.append((float(metrics["loss"]), float(jmetrics["loss"]),
                      _leaves(grads), _leaves(jgrads)))
    return dict(task=task, state=state, steps=steps, frozen=frozen,
                params=_leaves(trainable()),
                jax_params=_leaves(jstate.params))


@pytest.mark.parametrize("step", range(STEPS))
def test_train_step_loss_matches_jax(run, step):
    ours, theirs, _, _ = run["steps"][step]
    assert np.isfinite(ours)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)


@pytest.mark.parametrize("step", range(STEPS))
def test_train_step_gradients_match_jax(run, step):
    """Every trainable leaf's gradient (the core and the projections; the
    backbones take none), element by element."""
    _, _, grads, jax_grads = run["steps"][step]
    assert sorted(grads) == sorted(jax_grads)
    assert not any(k.startswith(tuple(f"['{f}']" for f in FROZEN_KEYS))
                   for k in grads)
    for name, g in jax_grads.items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_adam_steps_match_jax(run):
    assert run["state"].step == STEPS
    assert sorted(run["params"]) == sorted(run["jax_params"])
    for name, want in run["jax_params"].items():
        np.testing.assert_allclose(run["params"][name], want, rtol=0,
                                   atol=1e-6, err_msg=name)


def test_frozen_backbones_stay_bit_identical(run):
    model = run["task"].model
    after = model.state_dict()
    assert len(run["frozen"]) > 100
    for k, v in run["frozen"].items():
        assert torch.equal(after[k], v), k
    held = {id(p) for g in run["state"].optimizer.param_groups
            for p in g["params"]}
    for name, p in model.named_parameters():
        frozen = name.split(".", 1)[0] in FROZEN_KEYS
        assert p.requires_grad is not frozen and (id(p) in held) is not \
            frozen, name


def test_trainer_fits_on_a_combined_loader(task_name):
    """``Trainer.fit`` with ``fast_dev_run`` on a ``CombinedLoader`` of
    numpy batches (LAM's loader twice as long as the others, which cycle):
    one train step, one validation batch, the task's metrics, nothing
    saved."""
    task = getattr(multitask_hhi, task_name)(_cfg(), device="cpu")
    first, second = _batches(30), _batches(31)
    loader = CombinedLoader({"lam": [first["lam"], second["lam"]],
                             "ttm": [first["ttm"]], "asd": [first["asd"]]})
    assert [b["ttm"] is first["ttm"] for b in loader] == [True, True]
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(task, fast_dev_run=True, default_root_dir=root,
                          device="cpu")
        state = trainer.fit(loader, loader)
        assert state.step == 1
        assert trainer.ckpt._scores == {}
    (metrics,) = trainer.metrics_history
    assert metrics["epoch"] == 0 and np.isfinite(metrics["val_loss"])
    assert all(0.0 <= metrics[f"val_{t}_acc"] <= 1.0
               for t in ("lam", "ttm", "asd"))
