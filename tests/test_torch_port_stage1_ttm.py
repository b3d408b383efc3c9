"""The port's Stage-I TTM training against the JAX package's.

``egot2x_torch`` ``TalkingToMe`` on ``TTMBaselineLSTM`` against
``egot2x``'s own task: its ``build_state`` (Adam with weight decay 1e-4
through the JAX package's mask, as ``run_ttm --wd`` gives it) and its
jitted ``train_step``, from the same weights (the port task's seeded ones,
JAX layout through the weight bridge) on one bucket of B=2 segments of
T=15 frames at 32^2 with their raw audio (T / 30 s at 16 kHz), class
weights [0.266, 0.734], f32 on the CPU. Both run the video ResNet-18 and
the audio ResNetSE with BNs on batch statistics. The tolerances and the
oracle are test_torch_port_stage1_lam.py's, but for the trunks, the video
ResNet-18 and the ResNetSE, whose gradients meet ReLU kinks at this batch
(``TRUNK_RTOL``, ``LEAF_COSINE``).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.models.ttm  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.tasks.ttm import TalkingToMe as JaxTalkingToMe  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.tasks.ttm import TalkingToMe  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401
from test_torch_port_stage1_lam import (check_adam,  # noqa: E402
                                        check_statistics, check_step,
                                        jax_step_task, step_oracle)

B, T, IMG = 2, 15, 32
SAMPLES = T * 16000 // 30
WEIGHTS = [0.266, 0.734]
LR, WD, SEED = 5e-4, 1e-4, 2
TRUNKS = ("['trunk']['video_encoder']", "['trunk']['audio_encoder']")
# this batch puts ReLU inputs of both trunks within f32 rounding of 0 (in
# the port's f32 forward, 4 output ReLUs of the audio encoder's layer4
# and 4 of layer1 take the other side from its f64 forward; JAX's f32
# step lands off its own f64 by 5.7e-3 in the video trunk): the trunks
# hold by their whole norm at 2e-2 and each leaf at cosine 0.99, the other
# leaves by leaf norm at 1e-4. Readings (one thread): video 3.3e-3 whole,
# 5.7e-3 its worst leaf; audio 1.2e-2 whole, 1.8e-1 its worst leaf (the
# layer1.0 SE's fc0 bias, 4 elements of norm 4.5e-3), least cosine 0.9985;
# the head and the BiLSTM <= 3.2e-5; the port's f64 step is within 3e-3
# of JAX's on every audio leaf
TRUNK_RTOL, LEAF_COSINE = 2e-2, 0.99


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        frames=rng.standard_normal((B, T, IMG, IMG, 3)).astype(np.float32),
        audio=(rng.standard_normal((B, SAMPLES)) * 0.1).astype(np.float32),
        label=rng.integers(0, 2, B).astype(np.int32))


@pytest.fixture(scope="module")
def ttm():
    cfg = Config(model="TTMBaselineLSTM", weights=WEIGHTS, lr=LR, wd=WD,
                 img_size=IMG, buckets=(T,))
    task = TalkingToMe(cfg, device="cpu")
    state = task.build_state(SEED)
    variables = bridge.to_jax_variables(task.model)
    jax_model = jax_build("TTMBaselineLSTM")
    jax_task = jax_step_task(JaxTalkingToMe, cfg, variables, jax_model.apply,
                             class_weights=np.asarray(WEIGHTS, np.float32))
    oracle = step_oracle(task, state, jax_task, [_batch(20), _batch(21)])
    return dict(task=task, oracle=oracle, variables=variables,
                eval_fn=jax.jit(lambda v, x, a: jax_model.apply(v, x, a)))


def test_ttm_step_loss_and_gradients_match_jax(ttm):
    assert np.isfinite(ttm["oracle"]["metrics"]["loss"])
    check_step(ttm["oracle"], TRUNKS, TRUNK_RTOL, LEAF_COSINE)


def test_ttm_step_statistics_match_jax(ttm):
    """Every BN's running statistics after the step: the video trunk's,
    the audio encoder's and its attention BN's (over B*T')."""
    stats = ttm["oracle"]["stats"]
    assert any("att_bn" in k for k in stats)
    check_statistics(ttm["oracle"])


def test_ttm_adam_steps_match_jax(ttm):
    """Every parameter after 2 steps of Adam with decay off the 1-axis
    leaves."""
    check_adam(ttm["oracle"])
    groups = ttm["oracle"]["state"].optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [WD, 0.0]


def test_ttm_eval_forward_matches_jax(ttm):
    """The logits of an eval forward from the seeded weights."""
    task = TalkingToMe(ttm["task"].cfg, device="cpu")
    bridge.load_jax_variables(task.model, ttm["variables"])
    batch = _batch(22)
    with torch.no_grad():
        got = task.model.eval()(torch.from_numpy(batch["frames"]),
                                torch.from_numpy(batch["audio"]))
    want = ttm["eval_fn"](ttm["variables"], batch["frames"], batch["audio"])
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_ttm_validation_matches_jax(ttm):
    """eval_step, accumulate (a segment split over two batches, a padding
    row), merge of one process's context, finalize, against the JAX
    task's."""
    task = ttm["task"]
    variables = bridge.to_jax_variables(task.model)
    jax_task = object.__new__(JaxTalkingToMe)
    jax_state = SimpleNamespace(
        apply_fn=lambda v, x, a, train=False: ttm["eval_fn"](v, x, a),
        variables=lambda: variables)
    ctx, jax_ctx = task.start_validation(), jax_task.start_validation()
    for seed, segs, valid in ((23, ["a", "b"], [True, True]),
                              (24, ["b", "c"], [True, False])):
        batch = dict(_batch(seed), seg_id=segs, start=[0, 15], end=[15, 30],
                     valid=np.array(valid))
        got = task.eval_step(ttm["oracle"]["state"], {
            k: torch.from_numpy(batch[k]) for k in ("frames", "audio")})
        want = jax_task.eval_step(jax_state, batch)
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.asarray(want["logits"]), rtol=1e-4,
                                   atol=1e-4)
        task.accumulate(ctx, got, batch)
        jax_task.accumulate(jax_ctx, want, batch)
    ctx = task.merge_validation([ctx])
    jax_ctx = jax_task.merge_validation([jax_ctx])
    assert sorted(ctx["logits"]) == sorted(jax_ctx["logits"]) == ["a", "b"]
    assert ctx["span"] == jax_ctx["span"] and ctx["label"] == jax_ctx["label"]
    got, want = task.finalize_validation(ctx), \
        jax_task.finalize_validation(jax_ctx)
    assert sorted(got) == sorted(want) == ["val_acc", "val_mAP"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
