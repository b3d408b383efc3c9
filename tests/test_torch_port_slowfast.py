"""The port's SlowFast-R50 and the AR SlowFast models against the JAX package.

``egot2x_torch.nn.slowfast`` (``SlowFast``, ``FuseFastToSlow``,
``MultiTaskHead``) and ``egot2x_torch.models.ar_lta``
(``MultiTaskSlowFast``, ``SlowFastFeature``) against ``egot2x``'s, built by
each package's ``build_model`` at full width and depth (ResNet-50 pathways,
width 64, beta_inv 8) on 2 clips of uint8 pathways at 64^2: 8 fast frames
and 2 slow ones at alpha 4 (the ts_pnr geometry), 1 at alpha 8 (the AR
task's default), where the lateral convs take 8 frames to 2 and to 1.
Weights: ``random_jax_variables`` through the bridge; the pathways'
pixels are normalised in the stems, so the drawn BN statistics suit them
and none is fitted. f32 on the CPU, the JAX side jitted once an alpha: the
logits and the res5 maps, and at alpha 4 a ``SlowFastFeature`` on the same
trunk weights (its head drawn from the seed), from one jit that traces the
trunk once.

Tolerances: logits max |delta| <= 1e-4 (1 + |logit|); the res5 maps
elementwise at the same bar and each position's channel vector within
1e-5 of its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.models.ar_lta  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.models.ar_lta import SlowFastFeature as JaxFeature  # noqa: E402
from egot2x.nn.slowfast import MultiTaskHead as JaxHead  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.nn import slowfast  # noqa: E402
from test_torch_port_resnet3d import assert_close  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401
from test_torch_port_train import trunks_traced_once  # noqa: E402

B, T_FAST, IMG = 2, 8, 64
SEED = 5
TOKEN_TOL = 1e-5


def pathways(alpha, seed=1):
    """uint8 [slow (B, T / alpha, 64, 64, 3), fast (B, T, 64, 64, 3)]."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, t, IMG, IMG, 3)).astype(np.uint8)
            for t in (T_FAST // alpha, T_FAST)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def assert_maps_close(got, want):
    """NCTHW port maps against NTHWC JAX ones: elementwise, and each
    position's channel vector within TOKEN_TOL of its norm."""
    got = got.permute(0, 2, 3, 4, 1).numpy()
    want = np.asarray(want)
    assert_close(got, want)
    err = np.linalg.norm(got - want, axis=-1)
    assert (err <= TOKEN_TOL * np.linalg.norm(want, axis=-1)).all()


def _multitask(alpha, feature_head=None):
    """``MultiTaskSlowFast`` at ``alpha`` on both sides: its logits and its
    res5 maps (``middle=True``) from one jit. ``feature_head``: also a
    ``SlowFastFeature`` of that many outputs on the same trunk weights,
    its JAX tree built in the jit from the same trunk leaves, so that XLA
    compiles the trunk once."""
    port = build_model("MultiTaskSlowFast", device="cpu", alpha=alpha)
    variables = bridge.random_jax_variables(port, SEED)
    bridge.load_jax_variables(port, variables)
    jm = jax_build("MultiTaskSlowFast", alpha=alpha)
    x = pathways(alpha)
    head, feature = {}, None
    if feature_head:
        feature = build_model("SlowFastFeature", device="cpu", alpha=alpha,
                              feature_dim=feature_head)
        rng = np.random.default_rng(SEED + 1)
        dim = feature.head.projection_0.in_features
        head = {"projection_0": dict(
            kernel=(rng.standard_normal((dim, feature_head))
                    / np.sqrt(dim)).astype(np.float32),
            bias=(rng.standard_normal(feature_head) * 0.05).astype(
                np.float32))}
        bridge.load_jax_variables(feature, {
            "params": {"trunk": variables["params"]["trunk"], "head": head},
            "batch_stats": {"trunk": variables["batch_stats"]["trunk"]}})
    jf = JaxFeature(feature_dim=feature_head or 1, alpha=alpha)

    def forward(v, head, p):
        out = (jm.apply(v, p), jm.apply(v, p, middle=True))
        if not head:
            return out
        tree = {"params": {"trunk": v["params"]["trunk"], "head": head},
                "batch_stats": {"trunk": v["batch_stats"]["trunk"]}}
        return out + (jf.apply(tree, p),)

    # the three calls share one trunk trace (the same variables and inputs)
    forward = jax.jit(trunks_traced_once(forward, ("trunk",)))
    want = forward(variables, head, [jnp.asarray(a) for a in x])
    with torch.no_grad():
        got = (port(_torch(x)), port(_torch(x), middle=True))
        if feature is not None:
            got += (feature(_torch(x)),)
    return dict(alpha=alpha, port=port, jax_model=jm, variables=variables,
                x=x, got=got, want=want)


@pytest.fixture(scope="module")
def alpha4():
    return _multitask(4, feature_head=64)


@pytest.fixture(scope="module")
def alpha8():
    return _multitask(8)


@pytest.fixture(params=["alpha4", "alpha8"])
def multitask(request):
    return request.getfixturevalue(request.param)


def test_s5_maps_match_jax(multitask):
    (slow, fast), (want_slow, want_fast) = multitask["got"][1], \
        multitask["want"][1]
    t_slow = T_FAST // multitask["alpha"]
    assert slow.shape == (B, 2048, t_slow, 2, 2)
    assert fast.shape == (B, 256, T_FAST, 2, 2)
    assert np.isfinite(slow.numpy()).all() and np.isfinite(fast.numpy()).all()
    assert_maps_close(slow, want_slow)
    assert_maps_close(fast, want_fast)


def test_multitask_logits_match_jax(multitask):
    got, want = multitask["got"][0], multitask["want"][0]
    assert [g.shape for g in got] == [(B, 115), (B, 478)]
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w))


def test_random_variables_have_the_jax_tree_structure(alpha4):
    """alpha changes no weight's shape: one trace covers both."""
    init = jax.eval_shape(
        lambda p: alpha4["jax_model"].init(jax.random.key(0), p),
        [jnp.zeros(a.shape, jnp.uint8) for a in alpha4["x"]])
    structure = lambda tree: sorted(
        (jax.tree_util.keystr(p), np.shape(v))
        for p, v in jax.tree_util.tree_leaves_with_path(tree))
    for coll in ("params", "batch_stats"):
        assert structure(alpha4["variables"][coll]) == structure(init[coll])


def test_trunk_runs_channels_last(multitask):
    """The res5 maps and every conv weight are channels_last_3d: the
    concatenations on the channel axis keep the layout."""
    for m in multitask["got"][1]:
        assert m.is_contiguous(memory_format=torch.channels_last_3d)
    for m in multitask["port"].modules():
        if isinstance(m, torch.nn.Conv3d):
            assert m.weight.is_contiguous(
                memory_format=torch.channels_last_3d)


def test_float_feed_matches_uint8(multitask):
    """Float pathways are taken as they are: the normalised pixels give
    what the uint8 ones do."""
    x = [(torch.from_numpy(a).float() / 255.0 - 0.45) / 0.225
         for a in multitask["x"]]
    with torch.no_grad():
        got = multitask["port"](x)
    for g, w in zip(got, multitask["got"][0]):
        assert_close(g.numpy(), w.numpy(), tol=1e-5)


def test_fused_channel_counts():
    """Each fuse adds 2 dim / beta_inv channels to the slow pathway: 80,
    320, 640 and 1280 into res2..res5; the fast one carries 8..256; the
    lateral conv is (5, 1, 1) over the fast channels. Temporal kernels:
    1 on the slow pathway up to res3, 3 from res4; 5 at the fast stem."""
    with torch.device("meta"):
        trunk = slowfast.SlowFast(alpha=4)
    for stage, slow_in, fast_in in ((2, 80, 8), (3, 320, 32), (4, 640, 64),
                                    (5, 1280, 128)):
        slow_a = getattr(trunk, f"s{stage}_slow").block0.branch2.a.weight
        fast_a = getattr(trunk, f"s{stage}_fast").block0.branch2.a.weight
        assert slow_a.shape[1] == slow_in and fast_a.shape[1] == fast_in
        assert slow_a.shape[2] == (1 if stage < 4 else 3)
        assert fast_a.shape[2] == 3
        fuse = getattr(trunk, f"s{stage - 1}_fuse").conv_f2s.weight
        assert fuse.shape == (2 * fast_in, fast_in, 5, 1, 1)
    assert trunk.s1_fast.conv.weight.shape == (8, 3, 5, 7, 7)
    assert trunk.s1_slow.conv.weight.shape == (64, 3, 1, 7, 7)
    assert trunk.s5_slow.block2.branch2.c.weight.shape[0] == 2048


def test_depth101_keeps_six_temporal_blocks_in_res4():
    """``MultiTaskSlowFast`` passes ``depth`` but not
    ``num_block_temp_kernel``, as the JAX package's does: at depth 101
    res4's first 6 of 23 slow blocks take the temporal kernel 3."""
    with torch.device("meta"):
        model = slowfast.SlowFast(depth=101)
    kernels = [getattr(model.s4_slow, f"block{i}").branch2.a.weight.shape[2]
               for i in range(23)]
    assert kernels == [3] * 6 + [1] * 17


def test_slowfast_feature_matches_jax(alpha4):
    """``SlowFastFeature`` (a 64-output head, ``act="none"``) on the
    alpha-4 model's trunk weights."""
    got, want = alpha4["got"][2].numpy(), np.asarray(alpha4["want"][2])
    assert got.shape == (B, 64)
    assert_close(got, want)


def test_head_matches_jax():
    """Both pathways' global means, joined, one projection a head: logits
    at eval (the JAX head's default ``test_noact``)."""
    rng = np.random.default_rng(6)
    maps = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 2, 3, 3, 32), (2, 8, 3, 3, 8))]
    port = slowfast.MultiTaskHead(40, (5, 3)).eval()
    variables = {"params": {}}
    for i, n in enumerate((5, 3)):
        kernel = rng.standard_normal((40, n)).astype(np.float32) / 6
        bias = rng.standard_normal(n).astype(np.float32) * 0.05
        variables["params"][f"projection_{i}"] = dict(kernel=kernel,
                                                      bias=bias)
        proj = getattr(port, f"projection_{i}")
        with torch.no_grad():
            proj.weight.copy_(torch.from_numpy(kernel.T))
            proj.bias.copy_(torch.from_numpy(bias))
    want = JaxHead((5, 3)).apply(variables, [jnp.asarray(m) for m in maps])
    with torch.no_grad():
        got = port([torch.from_numpy(m).permute(0, 4, 1, 2, 3)
                    for m in maps])
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w), tol=1e-5)


@pytest.mark.parametrize("name", ["MultiTaskSlowFast", "SlowFastFeature"])
def test_quant_raises_by_name(name):
    """The JAX classes have no ``quant``, so the port's take none (their
    trunk, ``SlowFast``, takes it: tests/test_torch_port_quant3d*.py)."""
    with pytest.raises(TypeError, match="quant"):
        build_model(name, device="cpu", quant=True)
