"""Stage-II training with trainable trunks in the port against the JAX package.

``nofreeze`` differentiates the LAM, TTM and TalkNet trunks (still in
eval mode) through the float stems' gradient (``ops/stem.py::_StemPool``,
whose CPU halves run here); ``remat`` recomputes the trunks in the
backward. At the golden shapes of tests/test_torch_port_train.py (B=2,
T=4, IMG=64, faces 48^2, D=64, 1 layer, 4 heads), the same seeded weights
(JAX layout
through the weight bridge) and the same batches, f32 on the CPU:

* the stem Functions, 2D and 3D: gradients of x, weight, scale and bias
  against autograd of the plain forward (rtol 1e-5, atol 1e-6 of the
  leaf's largest element: the same products summed in another order), and
  the winners against ``F.max_pool2d``'s indices, exact ties included;
* the flagship ``TaskFusionMFTransformer3Task`` with ``nofreeze`` through
  ``TalkingToMe2Loader`` against ``egot2x``'s deterministic step, as
  tests/test_torch_port_train.py holds the frozen step (its JAX
  ``apply_gradients`` consumes the port's gradient, so both stay on one
  trajectory): loss rtol 1e-5; every gradient leaf, the trunks' conv
  kernels and BN scales and offsets included, rtol 1e-4 / atol 1e-6 at the
  first step and by leaf norm at the second (``LATER_STEP_RTOL`` relative
  for the core's leaves, ``TRUNK_LATER_RTOL`` for the trunks', plus 1e-6
  per element, from readings in PERF.md); the parameters after 2 Adam
  steps atol 1e-6; the trunks' BN statistics bit for bit;
* ``remat`` equal to no ``remat``, loss and every gradient bit for bit,
  with each stem's forward run twice;
* the refusals: an int8 stem that needs grad, a stem BN in training mode,
  ``quant_trunks`` with ``nofreeze``; ``remat`` alone trains.

The ASD 2-loader task's steps are held to the JAX task's in
tests/test_torch_port_asd_train.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import egot2x.translate.egot2s_hhi  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.tasks.lam import weighted_cross_entropy as jax_wce  # noqa: E402
from egot2x.train.optim import construct_optimizer as jax_opt  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.nn.resnet2d import ResNet2D  # noqa: E402
from egot2x_torch.nn.talknet import TalkNetModel  # noqa: E402
from egot2x_torch.ops import stem  # noqa: E402
from egot2x_torch.tasks.ttm_2loader import (TalkingToMe2Loader,  # noqa: E402
                                            TalkingToMe2Task)
from egot2x_torch.train.optim import construct_optimizer  # noqa: E402
from egot2x_torch.train.state import TrainState, split_params  # noqa: E402
from egot2x_torch.translate.egot2s_hhi import FROZEN_KEYS  # noqa: E402
from test_torch_port_train import (PackedAdam, _as_jax,  # noqa: E402
                                   _leaves, _no_dropout, _one_thread)

D, HEADS, LAYERS = 64, 4, 1
B, T, IMG = 2, 4, 64
FACE = 48   # TalkNet's grey faces (it pools them globally at any size)
WEIGHTS = [0.266, 0.734]
LR, WD, STEPS = 1e-3, 1e-2, 2
SEED = 1
LATER_STEP_RTOL = 5e-5
# a later step's trunk leaves: a ReLU input within f32 rounding of 0 may
# fall on the other side of the kink than in JAX's f32 forward (PERF.md)
TRUNK_LATER_RTOL = 2e-2
INPUTS = ("frames", "video_asd", "audio", "audio_asd")


def _cfg(**kw):
    base = dict(model="TaskFusionMFTransformer3Task", weights=WEIGHTS, lr=LR,
                wd=WD, hidden_dim=D, num_heads=HEADS, num_layers=LAYERS,
                dropout=0.0)
    return Config({**base, **kw})


def _batch(seed, n=B, t=T):
    rng = np.random.default_rng(seed)
    return dict(
        frames=rng.standard_normal((n, t, IMG, IMG, 3)).astype(np.float32),
        video_asd=rng.uniform(0, 255, (n, t, FACE, FACE)).astype(np.float32),
        audio=np.zeros((n, t * 16000 // 30), np.float32),
        audio_asd=rng.standard_normal((n, 4 * t, 13)).astype(np.float32),
        label=np.arange(n, dtype=np.int32) % 2)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _trunk_buffers(model):
    """Every BN statistic of the trunks."""
    return {k: v.clone() for k, v in model.named_buffers()
            if k.split(".", 1)[0] in FROZEN_KEYS}


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


# -- the stem's gradient ------------------------------------------------------

def _stem_case(kind, seed, tie=False):
    """(x, weight, scale, bias) of a small stem, f32; ``tie``: the first
    frame constant, so interior conv values tie exactly in every window."""
    rng = np.random.default_rng(seed)
    if kind == 2:
        x = rng.standard_normal((2, 37, 45, 3)).astype(np.float32)
        w = rng.standard_normal((64, 3, 7, 7)) / np.sqrt(147)
    else:
        x = rng.uniform(-2, 2, (2, 3, 29, 22)).astype(np.float32)
        w = rng.standard_normal((64, 1, 5, 7, 7)) / np.sqrt(245)
    if tie:
        x[0] = 0.5
    scale = rng.uniform(0.5, 1.5, 64)
    bias = rng.standard_normal(64) * 0.1
    return [torch.from_numpy(np.asarray(v, np.float32))
            for v in (x, w, scale, bias)]


_STEMS = {2: (stem.stem_pool_2d, stem.stem_pool_2d_plain),
          3: (stem.stem_pool_3d, stem.stem_pool_3d_plain)}


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
@pytest.mark.parametrize("kind", [2, 3], ids=["2d", "3d"])
def test_stem_function_gradients_match_plain_autograd(kind, tie):
    """The Function (its plain halves on the CPU) against autograd of the
    plain forward: the output bit for bit, every input's gradient."""
    fn, plain = _STEMS[kind]
    case = _stem_case(kind, 3, tie)
    ours = [v.clone().requires_grad_() for v in case]
    out = fn(*ours)
    assert out.grad_fn is not None and "StemPool" in type(out.grad_fn).__name__
    ref_in = [v.clone().requires_grad_() for v in case]
    ref = plain(*ref_in)
    assert torch.equal(out, ref)
    dp = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(out.shape)).astype(np.float32))
    got = torch.autograd.grad(out, ours, dp)
    want = torch.autograd.grad(ref, ref_in, dp)
    for name, g, w in zip(("x", "weight", "scale", "bias"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("kind", [2, 3], ids=["2d", "3d"])
def test_stem_winners_are_max_pool_indices(kind):
    """The training forward's winners are ``F.max_pool2d``'s indices as
    window positions (the first maximum in row-major order), ties too:
    on the constant frame every interior window ties and its winner is
    position 0. The saved values are the winners' conv values."""
    x, w, scale, bias = _stem_case(kind, 5, tie=True)
    out, win, yw = stem._TRAIN_PLAIN[kind](x, w, scale, bias)
    if kind == 2:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=3)
    else:
        y = stem._conv3d_frames(x, w)
    z = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    p, idx = F.max_pool2d(z, 3, 2, 1, return_indices=True)
    hc, wc = y.shape[-2:]
    ho, wo = p.shape[-2:]
    k = win.permute(0, 3, 1, 2).long()
    po = torch.arange(ho).view(ho, 1)
    pc = torch.arange(wo).view(1, wo)
    assert int(k.max()) <= 8
    assert torch.equal((2 * po - 1 + k // 3) * wc + 2 * pc - 1 + k % 3, idx)
    assert torch.equal(out, p.permute(0, 2, 3, 1))
    assert torch.equal(yw.permute(0, 3, 1, 2),
                       y.flatten(2).gather(2, idx.flatten(2)).view(p.shape))
    # frame 0 is constant (3D: clip 0 is): its conv values away from the
    # zero pad are equal per channel, so interior windows tie everywhere
    zi = z[0, :, 3:-3, 3:-3]
    assert bool((zi == zi[:, :1, :1]).all())
    assert bool((k[0, :, 2:-2, 2:-2] == 0).all())


def test_stem_backward_plain_routes_and_sums():
    """The backward's plain half by hand, every channel alike: the two
    outputs of the top row both won by conv position (0, 1) add there; a
    clipped output (p = 0) passes nothing; dscale sums g yw, dbias g."""
    hand = lambda rows, dtype=torch.float32: torch.tensor(
        rows, dtype=dtype)[None, :, :, None].expand(1, 2, 2, 64).contiguous()
    p = hand([[1.0, 4.0], [0.0, 3.0]])
    # conv (2 po - 1 + k // 3, 2 pc - 1 + k % 3): (0, 1), (0, 1), (2, 0),
    # (3, 3)
    win = hand([[5, 3], [4, 8]], torch.uint8)
    dp = hand([[1.0, 10.0], [100.0, 1000.0]])
    yw = torch.full((1, 2, 2, 64), 2.0)
    scale = torch.full((64,), 0.5)
    dy, dscale, dbias = stem.stem_pool_backward_plain(dp, p, win, yw, scale,
                                                      (4, 4))
    want = torch.zeros(1, 4, 4, 64)
    want[0, 0, 1] = 0.5 * (1.0 + 10.0)
    want[0, 3, 3] = 0.5 * 1000.0
    assert torch.equal(dy, want)
    assert torch.equal(dbias, torch.full((64,), 1011.0))
    assert torch.equal(dscale, torch.full((64,), 2022.0))


@pytest.mark.parametrize("foreach", [False, True])
def test_kernel_weights_follow_an_optimizer_step(foreach):
    """The kernel's weight cache keys on the weight's version: Adam's
    in-place update (either implementation) makes the fragments again, and
    the cache holds no autograd history."""
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(64, 3, 7, 7) * 0.1)
    taps = lambda: w.permute(2, 3, 1, 0).unsqueeze(0)
    before = stem._kernel_weights(2, taps(), torch.bfloat16)[0]
    assert stem._kernel_weights(2, taps(), torch.bfloat16)[0] is before
    opt = torch.optim.Adam([w], lr=0.1, foreach=foreach)
    w.grad = torch.ones_like(w)
    opt.step()
    after = stem._kernel_weights(2, taps(), torch.bfloat16)[0]
    assert after is not before and not torch.equal(after, before)
    assert torch.equal(after, stem.weight_fragments(
        taps().detach().reshape(1, 1, 7, 7, 3, 64)))
    for held, _ in stem._PREPARED.values():
        assert held.grad_fn is None and not held.requires_grad


# -- the flagship with trainable trunks ---------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """A CPU ``nofreeze`` task, its state from ``build_state`` (every
    parameter in Adam), and its weights then."""
    t = TalkingToMe2Loader(_cfg(nofreeze=True), device="cpu")
    state = t.build_state(SEED)
    return t, state, {k: v.clone() for k, v in t.model.state_dict().items()}


@pytest.fixture(scope="module")
def oracle(flagship):
    """The JAX deterministic ``nofreeze`` step and the port's, STEPS times
    on the same batches, on one trajectory (JAX's ``apply_gradients``
    consumes the port's gradient)."""
    t, state, _ = flagship
    model = _no_dropout(t.model)
    variables = bridge.to_jax_variables(model)
    stats_before = _trunk_buffers(model)
    jax_model = jax_build("TaskFusionMFTransformer3Task", hidden_dim=D,
                          num_heads=HEADS, num_layers=LAYERS, dropout=0.0,
                          nofreeze=True)
    params = variables["params"]
    weights = jnp.asarray(WEIGHTS)

    @jax.jit
    def grad_step(params, batch_stats, batch):
        def loss_fn(p):
            out = jax_model.apply({"params": p, "batch_stats": batch_stats},
                                  *(batch[k] for k in INPUTS), train=True,
                                  deterministic=True)
            return jax_wce(out, batch["label"], weights)
        return jax.value_and_grad(loss_fn)(params)

    # the JAX state's Adam over the packed tree (an optax state of the
    # whole tree would compile one small program a leaf shape)
    adam = PackedAdam(params, jax_opt(params, "adam", lr=LR,
                                      weight_decay=WD))
    shadow = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(0)
    steps = []
    for i in range(STEPS):
        batch = _batch(10 + i)
        jloss, jgrads = grad_step(params, variables["batch_stats"], {
            k: jnp.asarray(batch[k]) for k in INPUTS + ("label",)})
        state, metrics = t.train_step(state, _torch_batch(batch), gen)
        grads = _as_jax(shadow, _grads(model))
        params = adam.apply(grads).params()
        steps.append((float(metrics["loss"]), float(jloss), _leaves(grads),
                      _leaves(jgrads)))
    return dict(steps=steps, state=state, stats_before=stats_before,
                params=_leaves(_as_jax(shadow, dict(
                    model.named_parameters()))),
                jax_params=_leaves(params))


def test_nofreeze_step_loss_matches_jax(oracle):
    for ours, theirs, _, _ in oracle["steps"]:
        assert np.isfinite(ours)
        np.testing.assert_allclose(ours, theirs, rtol=1e-5)


def test_nofreeze_gradients_match_jax(oracle):
    """Every leaf's gradient of the first step, element by element: the
    fusion core's and the three trunks' (conv kernels, BN scales and
    offsets, TalkNet's every layer)."""
    _, _, grads, jax_grads = oracle["steps"][0]
    assert sorted(grads) == sorted(jax_grads)
    for key in ("['lam_model']['trunk']['base_model']['conv1']['kernel']",
                "['ttm_model']['trunk']['video_encoder']['bn1']['scale']",
                "['asd_model']['visual_frontend']['frontend3d_conv']"
                "['kernel']",
                "['asd_model']['visual_frontend']['frontend3d_bn']['bias']"):
        assert key in grads and np.abs(grads[key]).max() > 0, key
    for name, g in jax_grads.items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("step", range(1, STEPS))
def test_nofreeze_later_gradients_match_jax(oracle, step):
    """Each later step's gradients, each side's at its own parameters, by
    leaf norm: |g - g_jax| <= rtol |g_jax| + 1e-6 sqrt(size), rtol
    LATER_STEP_RTOL for the fusion core's leaves and TRUNK_LATER_RTOL for
    the trunks': after a step the two sides' weights differ by ~1e-7, and
    one ReLU input of the LAM trunk's layer4.0 then lies across the kink
    from JAX's, moving the LAM leaves below it by up to 9.9e-3 of their
    norm (readings at these batches, on one thread); the core's leaves
    read <= 2.5e-5 (leaves whose gradient is 0 in exact arithmetic, the
    attention key biases, by the atol).
    A gradient routed wrong is off by O(1)."""
    _, _, grads, jax_grads = oracle["steps"][step]
    assert sorted(grads) == sorted(jax_grads)
    for name, g in jax_grads.items():
        trunk = any(f"['{k}']" in name for k in FROZEN_KEYS)
        rtol = TRUNK_LATER_RTOL if trunk else LATER_STEP_RTOL
        err = np.linalg.norm(grads[name] - g)
        assert err <= rtol * np.linalg.norm(g) + 1e-6 * np.sqrt(g.size), (
            name, err, np.linalg.norm(g))


def test_nofreeze_adam_steps_match_jax(oracle):
    assert oracle["state"].step == STEPS
    assert sorted(oracle["params"]) == sorted(oracle["jax_params"])
    for name, want in oracle["jax_params"].items():
        np.testing.assert_allclose(oracle["params"][name], want, rtol=0,
                                   atol=1e-6, err_msg=name)


def test_nofreeze_trains_every_leaf_and_keeps_bn_statistics(oracle,
                                                             flagship):
    """Adam holds every parameter; each moved; the trunks' BN running
    statistics stay bit for bit (the trunks run in eval mode)."""
    t, _, snapshot = flagship
    state = oracle["state"]
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in t.model.parameters()}
    after = t.model.state_dict()
    for name, p in t.model.named_parameters():
        assert not torch.equal(p.detach(), snapshot[name]), name
    assert len(oracle["stats_before"]) > 100
    for k, v in oracle["stats_before"].items():
        assert torch.equal(after[k], v), k


def _counting(fn, calls):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        calls.append(fn.__name__)
        return fn(*args, **kwargs)
    return wrapped


def test_remat_matches_no_remat(flagship, monkeypatch):
    """One ``nofreeze`` step with and without ``remat`` (one model, the
    flag switched) from the same weights on the same batch: loss and every
    gradient bit for bit; under ``remat`` each stem's forward runs twice
    (the recompute), its backward once."""
    snapshot = flagship[2]
    t = TalkingToMe2Loader(_cfg(nofreeze=True), device="cpu")
    batch = _torch_batch(_batch(20, t=2))
    calls = []
    for kind in (2, 3):
        monkeypatch.setitem(stem._TRAIN_PLAIN, kind,
                            _counting(stem._TRAIN_PLAIN[kind], calls))
    monkeypatch.setattr(stem, "stem_pool_backward_plain",
                        _counting(stem.stem_pool_backward_plain, calls))
    out = {}
    for remat in (False, True):
        t.model.load_state_dict(snapshot)
        t.model.remat = remat
        trainable, _ = split_params(t.model, lambda k: False)
        state = TrainState(t.model,
                           construct_optimizer(trainable, "adam", LR, WD))
        calls.clear()
        _, metrics = t.train_step(state, batch, torch.Generator())
        out[remat] = (float(metrics["loss"]), _grads(t.model),
                      sorted(calls))
    assert out[False][2] == sorted(["stem_pool_2d_train_plain"] * 2
                                   + ["stem_pool_3d_train_plain"]
                                   + ["stem_pool_backward_plain"] * 3)
    assert out[True][2] == sorted(["stem_pool_2d_train_plain"] * 4
                                  + ["stem_pool_3d_train_plain"] * 2
                                  + ["stem_pool_backward_plain"] * 3)
    assert out[True][0] == out[False][0]
    assert sorted(out[True][1]) == sorted(out[False][1])
    for name, g in out[False][1].items():
        assert torch.equal(out[True][1][name], g), name


def test_remat_alone_trains_frozen():
    """``remat`` without ``nofreeze`` changes nothing, as in the JAX
    package: it builds and trains the fusion core with frozen trunks (the
    2-task translator, whose trunks are the flagship's less TalkNet)."""
    losses = []
    for remat in (False, True):
        t = TalkingToMe2Task(_cfg(model="TaskFusionMFTransformer2Task",
                                  remat=remat), device="cpu")
        state = t.build_state(SEED)
        _no_dropout(t.model)
        state, metrics = t.train_step(state, _torch_batch(_batch(30, t=2)),
                                      torch.Generator())
        losses.append(float(metrics["loss"]))
        for name, p in t.model.named_parameters():
            frozen = name.split(".", 1)[0] in FROZEN_KEYS
            assert (p.grad is None) is frozen, name
    assert losses[0] == losses[1]


def test_2task_translator_trains_its_trunks_with_nofreeze():
    t = TalkingToMe2Task(_cfg(model="TaskFusionMFTransformer2Task",
                              nofreeze=True), device="cpu")
    state = t.build_state(SEED)
    stats = _trunk_buffers(t.model)
    batch = _torch_batch(_batch(31, t=2))
    state, metrics = t.train_step(state, batch, torch.Generator())
    assert np.isfinite(float(metrics["loss"]))
    for name, p in t.model.named_parameters():
        assert p.grad is not None, name
    after = t.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in stats.items())


# -- what stays refused -------------------------------------------------------

def test_int8_stems_refuse_inputs_that_need_grad():
    """The int8 stems have no backward: inputs that need grad raise, on
    the CPU as on the card; under no_grad they compute."""
    x2, w2, scale, bias = _stem_case(2, 6)
    x3, w3, _, _ = _stem_case(3, 6)
    qs = torch.tensor([0.05])
    cases = ((stem.stem_pool_q_2d, x2, w2), (stem.stem_pool_q_3d, x3, w3))
    for fn, x, w in cases:
        with pytest.raises(ValueError, match="no backward"):
            fn(x, w.requires_grad_(), scale, bias, qs)
        with torch.no_grad():
            assert fn(x, w, scale, bias, qs).dtype == torch.int8
        w.requires_grad_(False)
        with pytest.raises(ValueError, match="no backward"):
            fn(x.requires_grad_(), w, scale, bias, qs)


def test_stem_bn_in_training_mode_raises():
    """The one configuration that would train an int8 trunk raises
    (``quant_trunks`` with ``nofreeze``); a translator's ``train()`` leaves
    every trunk stem's BN in eval, so under ``nofreeze`` its stems stay on
    the folded-statistics kernels and never take batch statistics."""
    with pytest.raises(ValueError, match="frozen trunks"):
        TalkingToMe2Loader(_cfg(quant_trunks=True, nofreeze=True),
                           device="cpu")
    model = TalkingToMe2Loader(_cfg(nofreeze=True), device="cpu").model
    model.train()
    stems = [m.bn1 for m in model.modules() if isinstance(m, ResNet2D)]
    stems += [m.visualFrontend.frontend3D[1] for m in model.modules()
              if isinstance(m, TalkNetModel)]
    assert len(stems) >= 2
    assert not any(bn.training for bn in stems)


def test_training_mode_stems_take_batch_statistics(monkeypatch):
    """A stem whose BN is in training mode normalises with batch
    statistics (Stage I), which no folded stem kernel computes: ResNet2D's
    and TalkNet's stems then run the library conv, the BN on the batch's
    statistics (updating the running ones at flax's momentum, 0.9 and
    0.99, with the biased variance), ReLU and the pool, and never reach
    the stem wrappers (made to raise here)."""
    import egot2x_torch.nn.resnet2d as resnet2d
    import egot2x_torch.nn.talknet as talknet_module
    import torch.nn.functional as F

    from egot2x_torch.nn.common import set_dropout_generator

    def refuse(*args):
        raise AssertionError("a training-mode stem reached the kernel")

    monkeypatch.setattr(resnet2d, "stem_pool_2d", refuse)
    monkeypatch.setattr(talknet_module, "stem_pool_3d", refuse)
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    model = ResNet2D().train()
    model(frames)
    with torch.no_grad():
        y = F.conv2d(frames.permute(0, 3, 1, 2), model.conv1.weight,
                     stride=2, padding=3)
    var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(model.bn1.running_mean, 0.1 * mean)
    torch.testing.assert_close(model.bn1.running_var, 0.9 + 0.1 * var)

    faces = torch.from_numpy(rng.uniform(0, 255, (2, 3, 32, 32)).astype(
        np.float32))
    talknet = set_dropout_generator(TalkNetModel().train(),
                                    torch.Generator())
    talknet(torch.zeros(2, 12, 13), faces)
    conv, bn = talknet.visualFrontend.frontend3D
    with torch.no_grad():
        y = F.conv3d(((faces / 255.0 - 0.4161) / 0.1688).unsqueeze(1),
                     conv.weight, stride=(1, 2, 2), padding=(2, 3, 3))
    var, mean = torch.var_mean(y, dim=(0, 2, 3, 4), correction=0)
    torch.testing.assert_close(bn.running_mean, 0.01 * mean)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var)


def test_bench_train_smoke_with_nofreeze_and_remat():
    from egot2x_torch.tools.bench_train import run

    out = run(batch=2, t=2, n_iter=1, img=64, device="cpu", nofreeze=True,
              remat=True)
    assert out["device"] == "cpu" and out["peak_mem_gib"] is None
    assert out["nofreeze"] is True and out["remat"] is True
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert "nofreeze: trainable backbones, remat" in out["config"]
