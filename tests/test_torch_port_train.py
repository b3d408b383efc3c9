"""The port's Stage-II training of the flagship against the JAX package.

``egot2x_torch`` ``TalkingToMe2Loader`` on ``TaskFusionMFTransformer3Task``
against ``egot2x``'s deterministic train step, at the golden shapes of
tests/test_torch_port_slice.py (B=2, T=4, IMG=64, D=64, 1 layer, 4 heads,
class weights [0.266, 0.734]; TalkNet's grey faces at 48^2, as the int8
tests take them), the same weights (the port task's seeded
weights, JAX layout through the weight bridge) and the same batches. The
JAX task's own ``train_step`` always drops out (the PE's rate is fixed at
0.1), so the oracle replays it with dropout off: ``jax.value_and_grad`` of
the weighted CE of ``apply(train=True, deterministic=True)`` over the
``split_params`` trainable tree, then ``TrainState.apply_gradients`` with
``construct_optimizer("adam", lr, wd)``; the port runs its step with
every dropout at p = 0. Both f32 on the CPU with full-precision matmuls,
the JAX step jitted once.

Tolerances: the loss of each step rtol 1e-5; every trainable gradient
leaf (the port's gradients mapped to JAX's names by the bridge, which is
linear) rtol 1e-4, atol 1e-6 at the first step, and by its norm at the
later ones (5e-5 relative plus that atol over the leaf); the parameters
after 3 Adam steps (lr 1e-3, wd 1e-2) atol 1e-6; frozen weights and BN
statistics bit for bit. Loss, mAP and the optimizer on toy inputs: 1e-6 / 1e-7.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import egot2x.translate.egot2s_hhi  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.metrics.map import run_evaluation as jax_evaluate  # noqa: E402
from egot2x.tasks.lam import weighted_cross_entropy as jax_wce  # noqa: E402
from egot2x.tasks.ttm import TalkingToMe as JaxTalkingToMe  # noqa: E402
from egot2x.train.optim import construct_optimizer as jax_opt  # noqa: E402
from egot2x.train.state import TrainState as JaxTrainState  # noqa: E402
from egot2x.train.state import merge_trees  # noqa: E402
from egot2x.train.state import split_params as jax_split_params  # noqa: E402
from egot2x.translate.egot2s_hhi import FROZEN_KEYS as JAX_FROZEN  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.checkpoint import graft_backbone  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.metrics.map import run_evaluation  # noqa: E402
from egot2x_torch.models.lam import LAMBackbone  # noqa: E402
from egot2x_torch.nn.common import Dropout, set_dropout_generator  # noqa: E402
from egot2x_torch.nn.quant import scale_buffers  # noqa: E402
from egot2x_torch.tasks.base import weighted_cross_entropy  # noqa: E402
from egot2x_torch.tasks.ttm_2loader import (TalkingToMe2Loader,  # noqa: E402
                                            TalkingToMe2Task)
from egot2x_torch.train.optim import construct_optimizer  # noqa: E402
from egot2x_torch.train.state import TrainState, split_params  # noqa: E402
from egot2x_torch.train.trainer import CheckpointManager, Trainer  # noqa: E402
from egot2x_torch.translate.egot2s_hhi import FROZEN_KEYS  # noqa: E402

D, HEADS, LAYERS = 64, 4, 1
B, T, IMG = 2, 4, 64
FACE = 48   # TalkNet's grey faces (it pools them globally at any size)
WEIGHTS = [0.266, 0.734]
LR, WD, STEPS = 1e-3, 1e-2, 3
SEED = 1
INPUTS = ("frames", "video_asd", "audio", "audio_asd")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch's CPU ops on one intra-op thread while a module runs. The
    tier-1 suite runs six test processes on the machine's cores, and each
    process's default pool of one thread a core oversubscribes them (the
    CPU steps of tests/test_torch_port_train_full.py ran up to ~100x
    slower there); one thread also makes f32 sums independent of the core
    count. Restored after the module. The other port test modules import
    it, which makes it theirs too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_call(a, b):
    """Two calls' (variables, args, kwargs): the very same objects (the
    same tracers, within one trace), or equal plain values."""
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return (jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
            and all(x is y or (not isinstance(x, jax.Array)
                               and not isinstance(y, jax.Array) and x == y)
                    for x, y in zip(la, lb)))


def trunks_traced_once(fn, names):
    """``fn`` with each call of a module named in ``names`` (the frozen
    trunks) that repeats an earlier call of this trace, by a module of the
    same path, type and configuration with the same variables and the
    same arguments, given that call's result instead of tracing the trunk
    again. The JAX oracles call their trunks once a task encode, and again
    in ``predict`` or in the second of two encodes of a batch; an
    eval-mode trunk is a pure function of its variables and inputs, so
    only the tracing and compiling shrink. Apply it to the function a
    ``jax.jit`` traces."""
    from flax import linen as flax_nn

    def config(module):
        return type(module), [(f, getattr(module, f))
                              for f in module.__dataclass_fields__
                              if f not in ("parent", "name")]

    def intercept(next_fun, args, kwargs, context, seen):
        module = context.module
        if context.method_name != "__call__" or module.name not in names:
            return next_fun(*args, **kwargs)
        key = (module.path, config(module), module.variables, args, kwargs)
        for other, out in seen:
            if other[:2] == key[:2] and _same_call(other[2:], key[2:]):
                return out
        out = next_fun(*args, **kwargs)
        seen.append((key, out))
        return out

    def traced(*args, **kwargs):
        seen = []
        with flax_nn.intercept_methods(
                lambda *a: intercept(*a, seen=seen)):
            return fn(*args, **kwargs)
    return traced


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
        label=np.arange(n, dtype=np.int32) % 2,
        seg_id=[f"seg{seed}_{i}" for i in range(n)],
        start=np.zeros(n, np.int32), end=np.full(n, t, np.int32))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def _fresh_state(task, snapshot):
    """The task's model back at ``snapshot``, with a new optimizer: a
    state as ``build_state`` makes it, without drawing the weights
    again."""
    task.model.load_state_dict(snapshot)
    trainable, _ = split_params(task.model, lambda k: k in FROZEN_KEYS)
    return TrainState(task.model,
                      construct_optimizer(trainable, "adam", LR, WD))


def _frozen_state(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.split(".", 1)[0] in FROZEN_KEYS}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# an optimizer that leaves the parameters as they are and keeps the
# gradient it is handed as its state: a JAX task's own jitted train_step
# with it gives that step's gradient exactly (``opt_state``) and compiles
# without the optimizer's update of every leaf (one object, so that jit
# sees one static ``tx``)
GRAD_CAPTURE = optax.GradientTransformation(
    lambda params: params,
    lambda grads, state, params=None: (
        jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def capture_grads(jstate):
    """``jstate`` (the JAX package's TrainState) with ``GRAD_CAPTURE`` as
    its optimizer."""
    return jstate.replace(tx=GRAD_CAPTURE,
                          opt_state=GRAD_CAPTURE.init(jstate.params))


class PackedAdam:
    """JAX's ``TrainState.apply_gradients`` with the state's own optimizer
    (``tx``, from ``egot2x/train/optim.py``), jitted over a packed tree:
    the leaves of two or more axes in one (1, N) array, the others in one
    (M,) array. optax's Adam, its schedules and the decay mask of
    ``construct_optimizer`` act element by element and by a leaf's rank,
    so a step is the same update as over the tree, in one small program;
    over a whole model's tree (a trainable trunk's hundreds of leaves) the
    jitted tree update takes ~5-12 s to compile."""

    def __init__(self, params, tx):
        leaves, self.treedef = jax.tree_util.tree_flatten(params)
        self.shapes = [np.shape(x) for x in leaves]
        self.decays = [len(s) >= 2 for s in self.shapes]
        self.state = JaxTrainState.create(apply_fn=None,
                                          params=self.pack(params), tx=tx)
        self._step = jax.jit(lambda js, g: js.apply_gradients(g))

    def pack(self, tree):
        flat = [np.ravel(np.asarray(x, np.float32))
                for x in jax.tree_util.tree_leaves(tree)]
        part = lambda d: np.concatenate(
            [f for f, k in zip(flat, self.decays) if k == d] or
            [np.zeros(0, np.float32)])
        return {"decayed": part(True)[None, :], "other": part(False)}

    def params(self):
        """The current parameters as the tree."""
        parts = {d: iter(np.split(np.asarray(self.state.params[k]).ravel(),
                                  np.cumsum([int(np.prod(s)) for s, dd in
                                             zip(self.shapes, self.decays)
                                             if dd == d])[:-1]))
                 for d, k in ((True, "decayed"), (False, "other"))}
        return jax.tree_util.tree_unflatten(self.treedef, [
            next(parts[d]).reshape(s) for s, d in zip(self.shapes,
                                                      self.decays)])

    def apply(self, grads):
        self.state = self._step(self.state, self.pack(grads))
        return self


def _as_jax(shadow, named):
    """``named`` (port parameter name -> tensor) as a JAX params tree,
    through the bridge on ``shadow``, a copy of the model: its parameters
    take ``named``'s values and zeros elsewhere, and the tree keeps the
    leaves that ``named`` reaches (the bridge maps each leaf from one
    parameter, linearly)."""
    with torch.no_grad():
        for n, p in shadow.named_parameters():
            p.fill_(1.0 if n in named else 0.0)
        reached = bridge.to_jax_variables(shadow)["params"]
        for n, p in shadow.named_parameters():
            p.copy_(named[n] if n in named else torch.zeros_like(p))
        values = bridge.to_jax_variables(shadow)["params"]
    return _prune(values, reached)


def _prune(tree, reached):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _prune(v, reached[k])
            if sub:
                out[k] = sub
        elif reached[k].any():
            out[k] = v
    return out


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """Stage-I checkpoints in the port's format: a TalkNetWithHeads
    (TalkNet under ``model``) and a LAM model (its trunk's names at the
    top, and a key the backbone does not take). Returns their paths and
    the backbone weights each carries."""
    root = tmp_path_factory.mktemp("stage1")
    torch.manual_seed(8)   # the modules' own initialization
    asd = build_model("TalkNetWithHeads", device="cpu")
    torch.save({"step": 0, "model": asd.state_dict()}, root / "asd.pt")
    lam = LAMBackbone().state_dict()
    torch.save({"step": 0, "model": {**lam, "lstm.weight": torch.ones(2)}},
               root / "lam.pt")
    return (dict(asd_checkpoint=str(root / "asd.pt"),
                 lam_checkpoint=str(root / "lam.pt")),
            asd.model.state_dict(), lam)


@pytest.fixture(scope="module")
def task(stage1):
    """One CPU task for the tests here, its state from ``build_state``
    (seeded weights, the Stage-I TalkNet and LAM grafted), and its weights
    then: tests that train start from them again."""
    t = TalkingToMe2Loader(_cfg(**stage1[0]), device="cpu")
    state = t.build_state(SEED)
    return t, state, {k: v.clone() for k, v in t.model.state_dict().items()}


@pytest.fixture(scope="module")
def oracle(task):
    """The JAX deterministic step and the port's, STEPS times on the same
    batches. Each step JAX takes the gradient at its own parameters, then
    its ``apply_gradients`` consumes the port's gradient, so that both
    stay on one trajectory: Adam's first steps scale a gradient g by
    lr / (|g| + eps), which turns a difference of 1e-8 in an element
    whose g + wd p nearly cancels into one of 1e-6 in the parameter, and
    that is the optimizer's conditioning, not a difference between the
    packages (the optimizer alone is held to optax in
    ``test_construct_optimizer_matches_optax``). Everything is compared in
    the JAX layout (the port's side through ``to_jax_variables`` on a
    shadow copy of the model, ``_as_jax``)."""
    t, state, _ = task
    model = _no_dropout(t.model)
    variables = bridge.to_jax_variables(model)
    frozen_before = _frozen_state(model)
    jax_model = jax_build("TaskFusionMFTransformer3Task", hidden_dim=D,
                          num_heads=HEADS, num_layers=LAYERS, dropout=0.0)
    trainable, frozen = jax_split_params(variables["params"],
                                         lambda k: k in JAX_FROZEN)
    jstate = JaxTrainState.create(
        apply_fn=jax_model.apply, params=trainable, frozen=frozen,
        tx=jax_opt(trainable, "adam", lr=LR, weight_decay=WD),
        batch_stats=variables["batch_stats"])
    weights = jnp.asarray(WEIGHTS)

    @jax.jit
    def grad_step(js, batch):
        def loss_fn(params):
            v = {"params": merge_trees(js.frozen, params),
                 "batch_stats": js.batch_stats}
            out = js.apply_fn(v, *(batch[k] for k in INPUTS), train=True,
                             deterministic=True)
            return jax_wce(out, batch["label"], weights)
        return jax.value_and_grad(loss_fn)(js.params)

    apply = jax.jit(lambda js, grads: js.apply_gradients(grads))
    shadow = copy.deepcopy(model)

    gen = torch.Generator().manual_seed(0)
    steps = []
    for i in range(STEPS):
        batch = _batch(10 + i)
        jloss, jgrads = grad_step(jstate, {
            k: jnp.asarray(batch[k]) for k in INPUTS + ("label",)})
        state, metrics = t.train_step(state, _torch_batch(batch), gen)
        grads = _as_jax(shadow, {n: p.grad for n, p in
                                 model.named_parameters()
                                 if p.grad is not None})
        jstate = apply(jstate, grads)
        steps.append((float(metrics["loss"]), float(jloss), _leaves(grads),
                      _leaves(jgrads)))
    names = {id(p): n for n, p in model.named_parameters()}
    groups = [_as_jax(shadow, {names[id(p)]: p for p in g["params"]})
              for g in state.optimizer.param_groups]
    return dict(steps=steps, state=state, frozen_before=frozen_before,
                params=_leaves(_as_jax(shadow, {
                    n: p for n, p in model.named_parameters()
                    if p.requires_grad})),
                jax_params=_leaves(jstate.params),
                jax_trainable=_leaves(trainable), groups=groups)


def test_train_step_loss_matches_jax(oracle):
    for ours, theirs, _, _ in oracle["steps"]:
        assert np.isfinite(ours)
        np.testing.assert_allclose(ours, theirs, rtol=1e-5)


def test_train_step_gradients_match_jax(oracle):
    """Every trainable leaf's gradient of the first step, element by
    element."""
    _, _, grads, jax_grads = oracle["steps"][0]
    assert sorted(grads) == sorted(jax_grads)
    for name, g in jax_grads.items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("step", range(1, STEPS))
def test_later_steps_gradients_match_jax(oracle, step):
    """Every trainable leaf's gradient of each later step, each side's at
    its own parameters, by the leaf's norm: |g - g_jax| <= 5e-5 |g_jax| +
    1e-6 sqrt(size), the first step's atol spread over the leaf. Both
    sides' parameters differ by ~1e-7 after an Adam step, and the larger
    losses of later steps carry that and the trunks' f32 differences into
    elements where the batch's terms cancel, so elementwise rtol 1e-4
    misses by up to 1.4e-6 there. Measured: the largest relative norm
    is 1.6e-5 (q_proj kernel, step 1); k_proj's bias, whose gradient is
    0 in exact arithmetic (softmax ignores a per-query constant), reads
    ~3e-8 on both sides. A gradient that carried the step before (a
    dropped zero_grad) or was taken at the wrong parameters is off by
    O(1)."""
    _, _, grads, jax_grads = oracle["steps"][step]
    assert sorted(grads) == sorted(jax_grads)
    for name, g in jax_grads.items():
        err = np.linalg.norm(grads[name] - g)
        assert err <= 5e-5 * np.linalg.norm(g) + 1e-6 * np.sqrt(g.size), (
            name, err, np.linalg.norm(g))


def test_adam_steps_match_jax(oracle):
    assert oracle["state"].step == STEPS
    assert sorted(oracle["params"]) == sorted(oracle["jax_params"])
    for name, want in oracle["jax_params"].items():
        np.testing.assert_allclose(oracle["params"][name], want, rtol=0,
                                   atol=1e-6, err_msg=name)


def test_optimizer_holds_the_jax_trainable_set(oracle):
    """The optimizer holds exactly the JAX trainable split, its decay
    group exactly the leaves of two or more axes (optax's mask): the
    packed in_proj weight and bias fall on the q/k/v kernels' and
    biases' sides."""
    decay, no_decay = (_leaves(g) for g in oracle["groups"])
    assert [g["weight_decay"] for g in
            oracle["state"].optimizer.param_groups] == [WD, 0.0]
    assert sorted({**decay, **no_decay}) == sorted(oracle["jax_trainable"])
    assert sorted(decay) == sorted(
        k for k, v in oracle["jax_trainable"].items() if v.ndim >= 2)
    assert "['core']['task_embed']" in decay


def test_frozen_weights_and_statistics_stay_bit_identical(oracle, task):
    model = task[0].model
    after = _frozen_state(model)
    assert sorted(after) == sorted(oracle["frozen_before"])
    for k, v in oracle["frozen_before"].items():
        assert torch.equal(after[k], v), k
    for name, p in model.named_parameters():
        frozen = name.split(".", 1)[0] in FROZEN_KEYS
        assert p.requires_grad is not frozen, name
        assert (p.grad is None) is frozen, name


def test_talknet_stays_in_eval_under_train(task):
    """The translator's backbones, TalkNet too, ignore ``train()``; the
    fusion core trains; Stage-I TalkNetWithHeads still trains its TalkNet."""
    model = task[0].model.train()
    try:
        for name, m in model.named_modules():
            top = name.split(".", 1)[0]
            assert m.training is (top not in FROZEN_KEYS), name
    finally:
        model.eval()
    stage1 = build_model("TalkNetWithHeads", device="cpu").train()
    assert all(m.training for m in stage1.modules())


def _logits(model, batch, generator=None):
    if generator is not None:
        set_dropout_generator(model, generator)
    with torch.no_grad():
        return model(*(_torch_batch(batch)[k] for k in INPUTS))


@pytest.fixture(scope="module")
def dropout_model(task):
    """The flagship at dropout 0.5 with the task's first weights, its
    trunks frozen as the task's are: on one thread the CPU's linear layers
    round a weight that requires grad apart from one that does not (even
    under ``no_grad``), which is not what the tests here compare."""
    model = build_model("TaskFusionMFTransformer3Task", device="cpu",
                        hidden_dim=D, num_heads=HEADS, num_layers=LAYERS,
                        dropout=0.5)
    model.load_state_dict(task[2])
    split_params(model, lambda k: k in FROZEN_KEYS)
    return model


def test_dropout_rates_sit_where_the_jax_package_drops(dropout_model):
    """The PE at 0.1 whatever ``dropout``; the encoder's four sites at it."""
    rates = {n: m.p for n, m in dropout_model.named_modules()
             if isinstance(m, Dropout) and not n.startswith("asd_model.")}
    layer = "transformer_encoder.layers.0."
    assert rates == {"pos_embed.dropout": 0.1,
                     layer + "self_attn.dropout": 0.5,
                     layer + "dropout": 0.5, layer + "dropout1": 0.5,
                     layer + "dropout2": 0.5}


def test_dropout_in_eval_is_the_inference_path(dropout_model, task):
    """At dropout 0.5 in eval mode, the logits of the same weights with
    every dropout at 0, bit for bit."""
    batch = _batch(20)
    reference = _no_dropout(task[0].model)
    reference.load_state_dict(task[2])
    dropout_model.train().eval()
    assert torch.equal(_logits(dropout_model, batch),
                       _logits(reference.eval(), batch))


def test_dropout_masks_come_from_the_generator(dropout_model):
    batch = _batch(21)
    dropout_model.train()
    rng_state = torch.get_rng_state()
    try:
        draw = lambda s: _logits(dropout_model, batch,
                                 torch.Generator().manual_seed(s))
        first, again, other = draw(0), draw(0), draw(1)
        eval_logits = _logits(dropout_model.eval(), batch)
    finally:
        dropout_model.eval()
    assert torch.equal(first, again)
    assert not torch.allclose(first, other, rtol=1e-3, atol=1e-3)
    assert not torch.allclose(first, eval_logits, rtol=1e-3, atol=1e-3)
    assert torch.equal(torch.get_rng_state(), rng_state)   # global RNG
    set_dropout_generator(dropout_model.train(), None)
    with pytest.raises(RuntimeError, match="generator"):
        _logits(dropout_model, batch)
    dropout_model.eval()


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_drops_a_binomial_share(p):
    drop = Dropout(p).train()
    drop.generator = torch.Generator().manual_seed(3)
    n = 200_000
    out = drop(torch.ones(n))
    dropped = int((out == 0).sum())
    assert abs(dropped - n * p) <= 5 * np.sqrt(n * p * (1 - p))
    assert torch.equal(out[out != 0], torch.full((n - dropped,),
                                                 1 / (1 - p)))
    assert torch.equal(drop.eval()(out), out)


def test_weighted_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((9, 2)).astype(np.float32) * 3
    labels = rng.integers(0, 2, 9)
    want = float(jax_wce(jnp.asarray(logits), jnp.asarray(labels),
                         jnp.asarray(WEIGHTS)))
    got = float(weighted_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels), WEIGHTS))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_run_evaluation_matches_jax():
    rng = np.random.default_rng(5)
    uids = [f"v{i % 37}" for i in range(50)]   # repeated rows dedup
    labels = rng.integers(0, 2, 50)
    scores = np.round(rng.uniform(size=50), 2)   # ties sort stably
    for n in (50, 1):
        np.testing.assert_allclose(
            run_evaluation(uids[:n], labels[:n], scores[:n]),
            jax_evaluate(uids[:n], labels[:n], scores[:n]),
            rtol=1e-6)


def test_segment_validation_matches_jax(task):
    """accumulate, merge_validation and finalize_validation against the
    JAX task's on the same logits: chunks of a segment split across two
    contexts and a padding row."""
    rng = np.random.default_rng(6)
    jax_task = object.__new__(JaxTalkingToMe)   # its hooks need no model
    ours_ctx, theirs_ctx = [], []
    for part in range(2):
        n = 6
        logits = rng.standard_normal((n, 2)).astype(np.float32)
        batch = dict(seg_id=[f"s{(part * 3 + i) % 5}" for i in range(n)],
                     label=np.asarray([(part * 3 + i) % 5 % 2
                                       for i in range(n)]),
                     start=rng.integers(0, 10, n), end=rng.integers(10, 20, n),
                     valid=np.arange(n) != n - 1)
        o, j = task[0].start_validation(), jax_task.start_validation()
        task[0].accumulate(o, {"logits": torch.from_numpy(logits)}, batch)
        jax_task.accumulate(j, {"logits": logits}, batch)
        ours_ctx.append(o)
        theirs_ctx.append(j)
    ours = task[0].finalize_validation(task[0].merge_validation(ours_ctx))
    theirs = jax_task.finalize_validation(
        jax_task.merge_validation(theirs_ctx))
    assert ours.keys() == theirs.keys() == {"val_mAP", "val_acc"}
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6)


def test_construct_optimizer_matches_optax():
    """Adam with coupled decay off the 1-D leaves, 5 steps on a toy tree
    against optax's chain of the JAX package, to 1e-7 absolute and
    relative: the two round the same formula in another order, one f32
    ulp of O(1) parameters (1.2e-7 at 1.3)."""
    rng = np.random.default_rng(7)
    shapes = {"w": (3, 4), "b": (4,), "e": (1, 3, 4)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = construct_optimizer(params, "adam", lr=1e-3, weight_decay=1e-2)
    tx = jax_opt(init, "adam", lr=1e-3, weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    update = jax.jit(tx.update)
    for _ in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        updates, st = update({k: jnp.asarray(g) for k, g in grads.items()},
                             st, jp)
        jp = optax.apply_updates(jp, updates)
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-7, atol=1e-7)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        construct_optimizer(params, "sgd")


def _toy_state(seed):
    torch.manual_seed(seed)
    model = torch.nn.Linear(3, 2)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=0.1))


def test_checkpoint_manager_keeps_top_k_and_the_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "val_mAP", "max", top_k=2)
    state = _toy_state(0)
    for epoch, score in enumerate([0.5, 0.9, 0.1, 0.2, 0.3]):
        state.step = epoch
        mgr.save(state, epoch, {"val_mAP": score})
        assert (tmp_path / f"epoch_{epoch}.pt").exists()   # just saved
    kept = sorted(p.name for p in tmp_path.glob("epoch_*.pt"))
    assert kept == ["epoch_0.pt", "epoch_1.pt", "epoch_4.pt"]
    assert json.loads((tmp_path / "last.json").read_text())["epoch"] == 4
    restored = mgr.restore(_toy_state(1), epoch=1)
    assert restored.step == 1
    assert torch.equal(restored.model.weight, state.model.weight)


def _loader(seeds, n=B):
    return [_batch(s, n) for s in seeds]


def test_fit_resumes_at_the_next_epoch(task, tmp_path):
    t, _, snapshot = task
    trainer = Trainer(t, max_epochs=1, default_root_dir=str(tmp_path / "a"),
                      device="cpu")
    state = trainer.fit(state=_fresh_state(t, snapshot),
                        train_loader=_loader([30]), val_loader=_loader([32]))
    saved = state.state_dict()
    ckpt = tmp_path / "a" / "checkpoints"
    assert sorted(p.name for p in ckpt.glob("*.pt")) == ["epoch_0.pt"]
    restored = CheckpointManager(str(ckpt), "val_mAP").restore(
        _fresh_state(t, snapshot))
    for k, v in saved["model"].items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    assert restored.step == saved["step"] == 1
    opt = restored.optimizer.state_dict()
    assert opt["param_groups"] == saved["optimizer"]["param_groups"]
    for i, s in saved["optimizer"]["state"].items():
        for key in s:
            assert torch.equal(opt["state"][i][key], s[key])
    resumed = Trainer(t, max_epochs=2, default_root_dir=str(tmp_path / "b"),
                      device="cpu")
    resumed.fit(state=_fresh_state(t, snapshot), resume_from=str(ckpt),
                train_loader=_loader([33]), val_loader=_loader([32]))
    assert [m["epoch"] for m in resumed.metrics_history] == [1]
    assert (tmp_path / "b" / "checkpoints" / "epoch_1.pt").exists()


def test_fast_dev_run_fits_one_batch_and_saves_nothing(task, tmp_path):
    t, _, snapshot = task
    trainer = Trainer(t, fast_dev_run=True, default_root_dir=str(tmp_path),
                      device="cpu")
    state = trainer.fit(state=_fresh_state(t, snapshot),
                        train_loader=_loader([40, 41]),
                        val_loader=_loader([42, 43]))
    assert state.step == 1
    (metrics,) = trainer.metrics_history
    assert 0.0 <= metrics["val_mAP"] <= 1.0 and 0.0 <= metrics["val_acc"] <= 1
    assert not list(tmp_path.rglob("*.pt"))


def test_quant_trunks_calibrate_on_the_first_batch(task, tmp_path):
    """int8 frozen trunks: the Trainer calibrates the scales (0 after
    build_state) on the first train batch, then trains the translator;
    the calibrated scales are the port's ``calibrate`` on that batch."""
    t, _, snapshot = task
    q = TalkingToMe2Loader(_cfg(quant_trunks=True), device="cpu")
    q.model.load_state_dict(snapshot, strict=False)   # scales stay 0
    trainable, _ = split_params(q.model, lambda k: k in FROZEN_KEYS)
    state = TrainState(q.model, construct_optimizer(trainable, "adam", LR))
    assert all(float(b) == 0.0 for _, b in scale_buffers(q.model))
    loader = _loader([50, 51])
    trainer = Trainer(q, fast_dev_run=True, default_root_dir=str(tmp_path),
                      device="cpu")
    trainer.fit(state=state, train_loader=loader, val_loader=_loader([52]))
    scales = {k: b.clone() for k, b in scale_buffers(q.model)}
    assert len(scales) > 50 and all(float(b) > 0 for b in scales.values())
    for _, b in scale_buffers(q.model):   # the trunks stayed frozen
        b.zero_()
    q.calibrate_state(state, _torch_batch(loader[0]))
    for name, b in scale_buffers(q.model):
        assert torch.equal(scales[name], b), name


def test_2task_translator_trains_with_frozen_trunks():
    t = TalkingToMe2Task(_cfg(model="TaskFusionMFTransformer2Task"),
                         device="cpu")
    trainable, _ = split_params(t.model, lambda k: k in FROZEN_KEYS)
    state = TrainState(t.model, construct_optimizer(trainable, "adam", LR))
    frozen = _frozen_state(t.model)
    state, metrics = t.train_step(state, _torch_batch(_batch(60, t=2)),
                                  torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    after = _frozen_state(t.model)
    assert all(torch.equal(v, after[k]) for k, v in frozen.items())


def test_graft_backbone_loads_stage1_checkpoints(task, stage1):
    """``build_state`` grafted the Stage-I TalkNet into ``asd_model`` (from
    the Stage-I model's ``model``) and the LAM trunk into ``lam_model``
    (its names at the top, the extra key ignored); a checkpoint without
    the backbone's keys raises."""
    paths, asd, lam = stage1
    snapshot = task[2]
    for key, want in (("asd_model", asd), ("lam_model", lam)):
        for k, v in want.items():
            assert torch.equal(snapshot[f"{key}.{k}"], v), k
    with pytest.raises(KeyError, match="ttm_model"):
        graft_backbone(task[0].model, "ttm_model", paths["asd_checkpoint"])


def test_unported_options_and_missing_card_raise(monkeypatch):
    """``quant_trunks`` with ``nofreeze`` and a missing card raise;
    ``nofreeze`` and ``remat``, ported since, build (their steps are held
    to JAX's in tests/test_torch_port_train_full.py)."""
    with pytest.raises(ValueError, match="frozen trunks"):
        TalkingToMe2Loader(_cfg(quant_trunks=True, nofreeze=True),
                           device="cpu")
    for flag in ("nofreeze", "remat"):
        model = TalkingToMe2Loader(_cfg(**{flag: True}), device="cpu").model
        assert getattr(model, flag) is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TalkingToMe2Loader(_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(object())


def test_bench_train_runs_at_a_toy_shape_on_the_cpu():
    from egot2x_torch.tools.bench_train import run

    out = run(batch=2, t=2, n_iter=1, img=64, device="cpu")
    assert out["device"] == "cpu" and out["device_busy_share"] is None
    assert out["metric"] == "egot2s_ttm_3task_train_clips_per_sec"
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert out["value"] > 0 and "batch 2, T=2" in out["config"]
