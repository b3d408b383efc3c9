"""The port's EgoT2-s HOI translators with a PNR or OSCC target against the
JAX package.

``egot2x_torch.translate.egot2s_hoi`` against ``egot2x.translate.
egot2s_hoi`` at the geometry of the JAX golden
``tests/test_torch_import_ts_pnr.py``, the trunks at full width and depth:
2 clips of 4 raw uint8 PNR frames at crop 65 (8192-d tokens, as at 225),
uint8 pathways of 2 slow and 8 fast frames at 64^2, alpha 4, D 64, 1
layer: 4 + 4 + 2 + 8 = 18 tokens.

``TaskFusionMFTransformer3TaskDropout`` (ts_pnr, ``target="keyframe"``) is
built by each package's ``build_model``, with ``random_jax_variables``
through the bridge and the statistics of the PNR and OSCC trunks' stem
BNs fitted to a calibration batch by precise BN (on raw [0, 255] pixels
the drawn ones, near (0, 1), blow the trunks up:
tests/test_torch_port_resnet3d.py), and run whole on both sides, the JAX
side jitted once; its logits and each stream's tokens are compared, and
that run records what the JAX trunks hand the translator (flax's method
interceptor). Every other model of the slice (ts_oscc, the transfer and
late-fusion baselines, the 2-task and simple_vit fusions) shares those
trunks: the port builds its own layers alone (the trunks not built),
draws them from a numpy seed, gives it the ts_pnr model's trunk modules
and runs it whole, the shared trunks answering a repeated call from the
first; the JAX side runs the model's own code on the recorded trunk
outputs (the same trunks on the same inputs), all of them in one jit.

Tolerances: logits max |delta| <= 1e-4 (1 + |logit|); tokens within 1e-5
of their norm per token. In bf16 (``tools/bench_hoi.py``'s QUANT=0
dtype), fed the recorded trunk outputs cast to bf16, each model's logits
are held within ``BF16_TOL`` and the dtype each LayerNorm takes and each
projection computes in, exactly. ``quant=True`` raises by name on every
model.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as flax_nn

torch = pytest.importorskip("torch")

import egot2x.translate.egot2s_hoi as jax_hoi  # noqa: E402
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import (MODEL_REGISTRY,  # noqa: E402
                                        build_model, place)
from egot2x_torch.nn.common import MultiHeadAttention  # noqa: E402
from egot2x_torch.train.precise_bn import (  # noqa: E402
    compute_precise_bn_stats)
from egot2x_torch.translate import egot2s_hoi  # noqa: E402
from test_torch_port_resnet3d import assert_close  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

B, T, CROP, T_FAST, IMG, ALPHA, D = 2, 4, 65, 8, 64, 4, 64
SEED = 7
TOKEN_TOL = 1e-5
# bf16 logits, max |delta| <= BF16_TOL (1 + |logit|): each package rounds
# to bf16 at its own points (a projection's bias add, the softmax), so
# the two differ by up to 0.0134 (1 + |logit|) over the 14 models here;
# the bar is ~3.7x that. A rounding in the wrong place stays inside it
# (the encoder's first residual sum in bf16: 0.0194), so the dtype at each
# LayerNorm and projection is held exactly
# (test_bf16_follows_the_jax_dtypes).
BF16_TOL = 0.05
TRUNKS = ("pnr_model", "oscc_model", "action_model")
GEOMETRY = dict(crop_size=CROP, alpha=ALPHA)
SEQUENCE = dict(pnr_frames=T, action_frames=T_FAST)
TS_PNR = dict(target="keyframe", feature_dim=D, num_layers=1)
# (name, JAX kwargs, port-only kwargs): every other PNR/OSCC-target model
VARIANTS = {
    "ts_oscc": ("TaskFusionMFTransformer3TaskDropout",
                dict(target="state", feature_dim=32, num_layers=2), SEQUENCE),
    "Keyframe2State": ("Keyframe2State", {}, {}),
    "State2Keyframe": ("State2Keyframe", {}, {}),
    "FinetuneState": ("FinetuneState", {}, {}),
    "FinetuneKeyframe": ("FinetuneKeyframe", {}, {}),
    "Action2State": ("Action2State", dict(feature_dim=D), {}),
    "Action2Keyframe": ("Action2Keyframe", dict(feature_dim=D), {}),
    "TaskFusionMFTransformer2TaskPnr": (
        "TaskFusionMFTransformer2TaskPnr", dict(target="state",
                                                feature_dim=D),
        dict(pnr_frames=T)),
    "TaskFusionLFLinearPnr": ("TaskFusionLFLinearPnr", {}, {}),
    "TaskFusionMFTransformer3TaskPnr": (
        "TaskFusionMFTransformer3TaskPnr",
        dict(feature_dim=D, depth=2, num_heads=4, dim_head=16, mlp_dim=96),
        SEQUENCE),
    "TaskFusionLFLinear3TaskPnr": ("TaskFusionLFLinear3TaskPnr",
                                   dict(target="state", feature_dim=D), {}),
    "TaskFusionLFLinear3TaskSimple": ("TaskFusionLFLinear3TaskSimple",
                                      dict(feature_dim=D), {}),
    "TaskFusionLFTransformer3TaskDropout": (
        "TaskFusionLFTransformer3TaskDropout",
        dict(target="state", feature_dim=D, num_layers=2), {}),
}
# the transfer baselines' fixed outputs; the others' follow ``target``
N_OUT = {"Keyframe2State": 2, "State2Keyframe": 16, "FinetuneState": 2,
         "FinetuneKeyframe": 16, "Action2State": 2, "Action2Keyframe": 16}


def inputs(seed):
    """uint8 (frames (B, T, 65, 65, 3), [slow, fast] pathways)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (B, T, CROP, CROP, 3)).astype(np.uint8)
    paths = [rng.integers(0, 256, (B, t, IMG, IMG, 3)).astype(np.uint8)
             for t in (T_FAST // ALPHA, T_FAST)]
    return frames, paths


def _torch(frames, paths):
    return torch.from_numpy(frames), [torch.from_numpy(p) for p in paths]


def _jax(frames, paths):
    return jnp.asarray(frames), [jnp.asarray(p) for p in paths]


def _trunk_calls(replace=None, record=None):
    """A flax interceptor of the translators' trunk calls: records what
    each returns into ``record``, or returns ``replace[name]`` instead of
    running it."""
    def intercept(next_fun, args, kwargs, context):
        name = context.module.name
        if context.method_name != "__call__" or name not in TRUNKS:
            return next_fun(*args, **kwargs)
        if replace is not None:
            return replace[name]
        record[name] = out = next_fun(*args, **kwargs)
        return out
    return flax_nn.intercept_methods(intercept)


def structure(tree):
    return sorted((jax.tree_util.keystr(p), np.shape(v))
                  for p, v in jax.tree_util.tree_leaves_with_path(tree))


def _same(a, b):
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return a is b or (not isinstance(a, torch.Tensor) and a == b)


@contextlib.contextmanager
def _trunks_run_once(port):
    """``port``'s trunk modules answer a call that repeats an earlier one
    (the same input tensors, the same arguments) with its output: the
    variants share them and run them on the same inputs, and the ts_pnr
    run held those outputs to the JAX trunks'. Every variant's own code
    still runs whole."""
    for key in TRUNKS:
        module, seen = getattr(port, key), []

        def forward(*args, _run=module.forward, _seen=seen, **kwargs):
            for other, out in _seen:
                if _same(other, (args, kwargs)):
                    return out
            out = _run(*args, **kwargs)
            _seen.append(((args, kwargs), out))
            return out
        module.forward = forward
    try:
        yield
    finally:
        for key in TRUNKS:
            del getattr(port, key).forward


@pytest.fixture(scope="module")
def ts_pnr():
    port = build_model("TaskFusionMFTransformer3TaskDropout", device="cpu",
                       **TS_PNR, **GEOMETRY, **SEQUENCE)
    drawn = bridge.random_jax_variables(port, SEED)
    bridge.load_jax_variables(port, drawn)
    compute_precise_bn_stats(port, [_torch(*inputs(9))], 1, bns=[
        port.pnr_model.trunk.s1.bn, port.oscc_model.trunk.s1.bn])
    variables = bridge.to_jax_variables(port)
    jm = jax_build("TaskFusionMFTransformer3TaskDropout", **TS_PNR,
                   **GEOMETRY)
    x = inputs(1)

    @jax.jit
    def forward(v, frames, paths):
        record = {}
        with _trunk_calls(record=record):
            logits = jm.apply(v, frames, paths)
        slow, fast = record["action_model"]
        return logits, dict(
            record, slow_tokens=jnp.mean(slow, axis=(2, 3)),
            fast_tokens=jax_hoi.adaptive_avg_pool_time(
                jnp.mean(fast, axis=(2, 3)), 8))

    want, record = forward(variables, *_jax(*x))
    with torch.no_grad(), _trunks_run_once(port):
        frames, paths = _torch(*x)
        slow, fast = port._action_token_streams(paths)
        tokens = dict(pnr_model=port._pnr_tokens(frames),
                      oscc_model=port._oscc_tokens(frames),
                      slow_tokens=slow, fast_tokens=fast)
        got = port(frames, paths)
    return dict(port=port, jax_model=jm, drawn=drawn, variables=variables,
                x=x, got=got, want=np.asarray(want), tokens=tokens,
                record=record)


def test_ts_pnr_logits_match_jax(ts_pnr):
    got = ts_pnr["got"].numpy()
    assert got.shape == (B, 16) and np.isfinite(got).all()
    assert_close(got, ts_pnr["want"])


@pytest.mark.parametrize("stream", ["pnr_model", "oscc_model", "slow_tokens",
                                    "fast_tokens"])
def test_ts_pnr_stream_tokens_match_jax(ts_pnr, stream):
    got = ts_pnr["tokens"][stream].numpy()
    want = np.asarray(ts_pnr["record"][stream])
    shape = {"pnr_model": (B, T, 8192), "oscc_model": (B, T, 8192),
             "slow_tokens": (B, T_FAST // ALPHA, 2048),
             "fast_tokens": (B, 8, 256)}[stream]
    assert got.shape == want.shape == shape
    err = np.linalg.norm(got - want, axis=-1)
    assert (err <= TOKEN_TOL * np.linalg.norm(want, axis=-1)).all()


def test_ts_pnr_uint8_feed_equals_f32(ts_pnr):
    """Raw f32 frames are the uint8 ones cast; f32 pathways are the
    normalised pixels."""
    frames, paths = ts_pnr["x"]
    f32_paths = [(torch.from_numpy(p).float() / 255.0 - 0.45) / 0.225
                 for p in paths]
    with torch.no_grad():
        got = ts_pnr["port"](torch.from_numpy(frames).float(), f32_paths)
    assert_close(got.numpy(), ts_pnr["got"].numpy(), tol=1e-5)


def test_random_variables_have_the_jax_tree_structure(ts_pnr):
    """The bridge's draw has the JAX init's tree (no head projection on the
    PNR and OSCC trunks, ``core/pe`` (1, 18, D))."""
    init = jax.eval_shape(
        lambda f, p: ts_pnr["jax_model"].init(jax.random.key(0), f, p),
        *_jax(*inputs(0)))
    for coll in ("params", "batch_stats"):
        assert structure(ts_pnr["drawn"][coll]) == structure(init[coll])
    assert ts_pnr["drawn"]["params"]["core"]["pe"].shape == (1, 18, D)


def test_trunks_stay_frozen_in_train_mode(ts_pnr):
    """``train()`` leaves the trunks in eval mode (the JAX translators run
    them with ``train=False``); their outputs carry no gradient."""
    port = ts_pnr["port"]
    try:
        port.train()
        assert all(not m.training for k in TRUNKS
                   for m in getattr(port, k).modules())
        assert port.core.training
        frames, paths = _torch(*ts_pnr["x"])
        assert not port._pnr_tokens(frames).requires_grad
    finally:
        port.eval()


@pytest.mark.parametrize("t,out_t", [(8, 8), (32, 8), (7, 3), (10, 4),
                                     (3, 5)])
def test_adaptive_avg_pool_time_matches_jax(t, out_t):
    x = np.random.default_rng(t).standard_normal((2, t, 6)).astype(
        np.float32)
    got = egot2s_hoi.adaptive_avg_pool_time(torch.from_numpy(x), out_t)
    want = jax_hoi.adaptive_avg_pool_time(jnp.asarray(x), out_t)
    assert_close(got.numpy(), np.asarray(want), tol=1e-6)


def _draw_layers(model, rng):
    """The translator's own layers from ``rng``: matrices and the PE
    N(0, 1 / fan_in) (the PE N(0, 1)), LayerNorm scales U(0.8, 1.2),
    biases N(0, 0.05^2)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("pe"):
                v = rng.standard_normal(p.shape)
            elif p.dim() >= 2:
                v = rng.standard_normal(p.shape) / np.sqrt(p.shape[-1])
            elif name.endswith("weight"):
                v = rng.uniform(0.8, 1.2, p.shape)
            else:
                v = rng.standard_normal(p.shape) * 0.05
            p.copy_(torch.from_numpy(v.astype(np.float32)))


def _own_layers(name, kw, tokens, dtype=torch.float32):
    """``name`` with its own layers allocated on the CPU, uninitialised,
    and an empty module in place of each trunk (``tokens``: the PNR and
    OSCC trunks' token width, which sizes the projections). The trunks
    are not built: the caller puts in shared ones."""
    def placeholder(self, key):
        trunk = torch.nn.Module()
        trunk.tokens = tokens
        setattr(self, key, trunk)

    mixin = egot2s_hoi._HOIStreamMixin
    adds = {"_add_pnr": "pnr_model", "_add_oscc": "oscc_model",
            "_add_action": "action_model"}
    saved = {a: getattr(mixin, a) for a in adds}
    try:
        for a, key in adds.items():
            setattr(mixin, a, lambda self, key=key: placeholder(self, key))
        with torch.device("meta"):
            model = MODEL_REGISTRY.get(name)(**kw, **GEOMETRY, dtype=dtype)
    finally:
        for a, f in saved.items():
            setattr(mixin, a, f)
    return model.to_empty(device="cpu")


def _variant(ts_port, name, kw, port_kw, rng):
    """``name`` on the CPU holding ``ts_port``'s trunk modules, and the JAX
    tree of its own layers, drawn from ``rng``."""
    model = _own_layers(name, dict(kw, **port_kw), ts_port.pnr_model.tokens)
    _draw_layers(model, rng)
    tree = bridge.to_jax_variables(model)
    for key in TRUNKS:
        if hasattr(model, key):
            setattr(model, key, getattr(ts_port, key))
    return place(model, "cpu"), tree


@pytest.fixture(scope="module")
def variants(ts_pnr):
    rng = np.random.default_rng(SEED + 1)
    ports, trees, models = {}, {}, {}
    for case, (name, kw, port_kw) in VARIANTS.items():
        ports[case], trees[case] = _variant(ts_pnr["port"], name, kw,
                                            port_kw, rng)
        models[case] = jax_build(name, **kw, **GEOMETRY)
    record = ts_pnr["record"]
    trunk_outs = {k: record[k] for k in TRUNKS}

    @jax.jit
    def forward(trees, frames, paths):
        with _trunk_calls(replace=trunk_outs):
            return {case: m.apply(trees[case], frames, paths)
                    for case, m in models.items()}

    frames, paths = ts_pnr["x"]
    want = forward(trees, *_jax(frames, paths))
    x = _torch(frames, paths)
    with torch.no_grad(), _trunks_run_once(ts_pnr["port"]):
        got = {case: m(*x) for case, m in ports.items()}
    inits = {}
    with _trunk_calls(replace=trunk_outs):
        for case, m in models.items():
            inits[case] = jax.eval_shape(
                lambda f, p, m=m: m.init(jax.random.key(0), f, p),
                *_jax(frames, paths))
    return dict(ports=ports, got=got, want=want, trees=trees, inits=inits)


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_variant_logits_match_jax(variants, case):
    got, want = variants["got"][case].numpy(), np.asarray(
        variants["want"][case])
    name, kw, _ = VARIANTS[case]
    n_out = N_OUT.get(case, 2 if kw.get("target") == "state" else 16)
    assert got.shape == (B, n_out) and np.isfinite(got).all()
    assert_close(got, want)


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_variant_layers_have_the_jax_tree_structure(variants, case):
    """The translator's own layers (the trunks' are the ts_pnr model's)
    form the JAX init's tree."""
    for coll in ("params", "batch_stats"):
        want = variants["inits"][case].get(coll, {})
        assert (structure(variants["trees"][case].get(coll, {}))
                == structure(want))


class _Replay(torch.nn.Module):
    """A trunk that hands back a recorded output."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def forward(self, *args, **kwargs):
        return self.out


# The dtype of each LayerNorm's input (the residual stream's, or a
# residual sum's) and of each projection's output (the dtype it computes
# in), in call order, as (module name, "ln_in" or "dense", dtype).


def _port_dtype_events(model):
    """Hooks on ``model`` that append its dtype events to the list they
    return; the attention's one q, k, v projection counts as ``q_proj``."""
    events = []
    names = {m: n.rsplit(".", 1)[-1] for n, m in model.named_modules()}
    dt = lambda t: str(t.dtype).removeprefix("torch.")
    for m in model.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.register_forward_pre_hook(lambda mod, a: events.append(
                (names[mod], "ln_in", dt(a[0]))))
        elif isinstance(m, MultiHeadAttention):
            m.register_forward_pre_hook(lambda mod, a: events.append(
                ("q_proj", "dense", dt(a[0]))))
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(lambda mod, a, out: events.append(
                (names[mod], "dense", dt(out))))
    return events


def _jax_dtype_events(events, replace):
    """A flax interceptor that appends the dtype events to ``events`` and
    answers the trunk calls with ``replace[name]``."""
    def intercept(next_fun, args, kwargs, context):
        module = context.module
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        if module.name in TRUNKS:
            return replace[module.name]
        if isinstance(module, flax_nn.LayerNorm):
            events.append((module.name, "ln_in", str(args[0].dtype)))
        out = next_fun(*args, **kwargs)
        if (isinstance(module, flax_nn.Dense)
                and module.name not in ("k_proj", "v_proj")):
            events.append((module.name, "dense", str(out.dtype)))
        return out
    return flax_nn.intercept_methods(intercept)


# ts_pnr and every variant in bf16 (``tools/bench_hoi.py``'s QUANT=0
# dtype), fed the ts_pnr run's recorded trunk outputs cast to bf16
BF16_CASES = {"ts_pnr": ("TaskFusionMFTransformer3TaskDropout", TS_PNR,
                         SEQUENCE), **VARIANTS}


@pytest.fixture(scope="module")
def bf16_runs(ts_pnr, variants):
    """Each model of ``BF16_CASES`` built in bf16 on both sides with the
    f32 run's weights of its own layers, its trunks answered with the
    recorded outputs: logits and dtype events."""
    record = ts_pnr["record"]
    outs = {k: jnp.asarray(record[k], jnp.bfloat16)
            for k in ("pnr_model", "oscc_model")}
    outs["action_model"] = [jnp.asarray(m, jnp.bfloat16)
                            for m in record["action_model"]]
    as_torch = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    port_outs = {k: as_torch(outs[k]).bfloat16()
                 for k in ("pnr_model", "oscc_model")}
    port_outs["action_model"] = [as_torch(m).permute(0, 4, 1, 2, 3)
                                 .bfloat16() for m in outs["action_model"]]
    f32 = dict(variants["ports"], ts_pnr=ts_pnr["port"])
    trees = dict(variants["trees"], ts_pnr={
        coll: {k: v for k, v in tree.items() if k not in TRUNKS}
        for coll, tree in ts_pnr["variables"].items()})
    models, got, got_events = {}, {}, {}
    frames, paths = ts_pnr["x"]
    tokens = ts_pnr["port"].pnr_model.tokens
    for case, (name, kw, port_kw) in BF16_CASES.items():
        model = _own_layers(name, dict(kw, **port_kw), tokens,
                            torch.bfloat16)
        model.load_state_dict({k: v for k, v in f32[case].state_dict().items()
                               if k.split(".", 1)[0] not in TRUNKS})
        for key in TRUNKS:
            if hasattr(model, key):
                setattr(model, key, _Replay(port_outs[key]))
        got_events[case] = _port_dtype_events(model)
        with torch.no_grad():
            got[case] = place(model, "cpu")(*_torch(frames, paths))
        models[case] = jax_build(name, **kw, **GEOMETRY, dtype=jnp.bfloat16)
    want_events = {case: [] for case in models}

    @jax.jit
    def forward(trees, frames, paths):
        res = {}
        for case, m in models.items():
            with _jax_dtype_events(want_events[case], outs):
                res[case] = m.apply(trees[case], frames, paths)
        return res

    want = forward(trees, *_jax(frames, paths))
    return dict(got=got, want=want, got_events=got_events,
                want_events=want_events)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_follows_the_jax_dtypes(bf16_runs, case):
    """In bf16 every LayerNorm takes, and every projection computes in,
    the dtype the JAX package's does: the f32 sum of the bf16 LN output
    and the f32 PE, the post-LN encoder's f32 first residual sum and bf16
    after it, simple_vit's f32 stream under bf16 blocks, bf16 heads. A
    rounding in the wrong place moves the logits by no more than the two
    packages' bf16 rounding noise (``BF16_TOL``), so it is held here."""
    got = bf16_runs["got_events"][case]
    assert got and got == bf16_runs["want_events"][case]


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_logits_match_jax(bf16_runs, case):
    got, want = bf16_runs["got"][case], bf16_runs["want"][case]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert_close(got.float().numpy(), np.asarray(want, np.float32),
                 tol=BF16_TOL)


@pytest.mark.parametrize("name", sorted({v[0] for v in VARIANTS.values()}))
def test_quant_raises_by_name(name):
    with pytest.raises(NotImplementedError, match="QuantConv3D"):
        build_model(name, device="cpu", quant=True)
