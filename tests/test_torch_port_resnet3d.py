"""The port's ResNet3D trunk, Nonlocal block and PNR heads against the
JAX package.

``egot2x_torch.nn.resnet3d`` against ``egot2x.nn.resnet3d`` at depth 50,
``width_per_group`` 4 (stage widths 16-128), crop 65, 4 frames, 2 clips,
with the same weights (``random_jax_variables``, JAX layout through the
weight bridge) and the same uint8 frames (numpy seed), f32 on the CPU, the
JAX side jitted. Two trunks cover the paths:

  * ``slow_layer5`` with ``input_norm=None`` (raw pixels, only cast), a
    ``dot_product`` Nonlocal after res2 block 1 and one after res3 block 1
    with ``nonlocal_group`` 2 (T folded into the batch), both pooled
    (1, 2, 2);
  * ``i3d`` with ``input_norm=(0.45, 0.225)`` (normalised in the stem), its
    5x7x7 stem, the VALID temporal max-pool after res2 (POOL1) and
    ``softmax`` Nonlocals after res2 block 0 and res4 block 1.

The Nonlocals' BN scales come from the bridge's draw (0.8-1.2): live, so
a wrong affinity shows (a zero-init BN would make each block the
identity). Random weights on raw [0, 255] frames grow without bound: the
stem's BN statistics, near (0, 1), do not match pixels of ~100, and a
``dot_product`` Nonlocal is cubic in its input. So the statistics of the
stem's BN and of each ``dot_product`` Nonlocal's BN are set from a
calibration batch by the port's precise BN (``train/precise_bn.py``, those
layers only), as a trained model's match its inputs; every other
statistic is the bridge's draw. (A ``softmax`` Nonlocal averages g, and
its output varies little across positions: statistics fitted to it would
scale rounding by ~200, so its drawn ones are kept.)

Tolerance: max |delta| <= 1e-4 (1 + |ref|) elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.nn import resnet3d as jax_r3d  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import place  # noqa: E402
from egot2x_torch.nn import resnet3d  # noqa: E402
from egot2x_torch.train.precise_bn import (  # noqa: E402
    compute_precise_bn_stats)
from test_torch_port_train import _one_thread  # noqa: E402,F401

B, T, CROP = 2, 4, 65
ARGS = dict(depth=50, width_per_group=4)
TOL = 1e-4
SEED = 3
# (arch, input_norm, resolve_nonlocal's arguments)
CASES = {
    "slow_layer5_dot_product_group2": (
        "slow_layer5", None,
        dict(location=[[[1]], [[1]], [[]], [[]]],
             group=[[1], [2], [1], [1]], instantiation="dot_product")),
    "i3d_softmax_normalised": (
        "i3d", (0.45, 0.225),
        dict(location=[[[0]], [[]], [[1]], [[]]], instantiation="softmax")),
}


def _frames(seed, n=B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, T, CROP, CROP, 3)).astype(np.uint8)


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert err.max() <= 0, (np.abs(got - want).max(), np.abs(want).max())


def seeded(model, frames, stem_bn, seed=SEED):
    """``model`` with the bridge's seeded weights, the statistics of
    ``stem_bn`` and of every ``dot_product`` Nonlocal's BN set from
    ``frames`` by precise BN; returns the JAX variable tree of it."""
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, seed))
    bns = [stem_bn] + [m.bn for m in model.modules()
                       if isinstance(m, resnet3d.Nonlocal)
                       and m.instantiation == "dot_product"]
    compute_precise_bn_stats(model, [(frames,)], 1, bns=bns)
    return bridge.to_jax_variables(model)


@pytest.fixture(scope="module", params=sorted(CASES))
def trunk(request):
    arch, norm, nl = CASES[request.param]
    port_nl = resnet3d.resolve_nonlocal(**nl)
    jax_nl = jax_r3d.resolve_nonlocal(**nl)
    model = place(resnet3d.ResNet3D(arch=arch, input_norm=norm,
                                    nonlocal_cfg=port_nl, **ARGS), "cpu")
    variables = seeded(model, torch.from_numpy(_frames(9)), model.s1.bn)
    jax_model = jax_r3d.ResNet3D(arch=arch, input_norm=norm,
                                 nonlocal_cfg=jax_nl, **ARGS)
    x = _frames(1)
    want = np.asarray(jax.jit(lambda v, f: jax_model.apply(v, f))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return dict(name=request.param, arch=arch, norm=norm, model=model,
                variables=variables, jax_model=jax_model, x=x, got=got,
                want=want, port_nl=port_nl, jax_nl=jax_nl)


def test_trunk_matches_jax(trunk):
    got = trunk["got"].permute(0, 2, 3, 4, 1).numpy()   # NCTHW -> NTHWC
    t_out = T // jax_r3d.POOL1[trunk["arch"]][0]
    assert got.shape == (B, t_out, 3, 3, 128)
    assert np.isfinite(got).all()
    assert_close(got, trunk["want"])


def test_trunk_runs_channels_last(trunk):
    """The NTHWC frames' NCTHW view is channels_last_3d, and so are the
    trunk's weights and output: no layout copy on the way."""
    assert trunk["got"].is_contiguous(memory_format=torch.channels_last_3d)
    for m in trunk["model"].modules():
        if isinstance(m, torch.nn.Conv3d):
            assert m.weight.is_contiguous(
                memory_format=torch.channels_last_3d)


def test_float_feed_matches_uint8(trunk):
    """Float frames are taken as they are: the raw pixels as floats where
    ``input_norm`` is None, the normalised ones otherwise."""
    x = torch.from_numpy(trunk["x"]).float()
    if trunk["norm"] is not None:
        mean, std = trunk["norm"]
        x = (x / 255.0 - mean) / std
    with torch.no_grad():
        got = trunk["model"](x)
    assert_close(got.numpy(), trunk["got"].numpy(), tol=1e-5)


def test_nonlocal_blocks_are_live(trunk):
    """The Nonlocals sit where resolve_nonlocal puts them, each with a
    live BN (the bridge's scales) and doing work: zeroing its BN scale
    moves the trunk's output."""
    assert trunk["port_nl"] == trunk["jax_nl"]
    blocks = {n: m for n, m in trunk["model"].named_modules()
              if isinstance(m, resnet3d.Nonlocal)}
    expect = {f"s{s + 2}.nonlocal{i}" for s, inds in
              enumerate(trunk["port_nl"][0]) for i in inds}
    assert set(blocks) == expect
    block = next(iter(blocks.values()))
    assert (block.bn.weight.abs() > 0.5).all()
    saved = block.bn.weight.detach().clone()
    try:
        with torch.no_grad():
            block.bn.weight.zero_()
            moved = trunk["model"](torch.from_numpy(trunk["x"]))
    finally:
        with torch.no_grad():
            block.bn.weight.copy_(saved)
    assert (moved - trunk["got"]).abs().max() > 1e-3


def test_random_variables_have_the_jax_tree_structure(trunk):
    init = jax.eval_shape(
        lambda f: trunk["jax_model"].init(jax.random.key(0), f),
        jnp.zeros((B, T, CROP, CROP, 3), jnp.uint8))
    structure = lambda tree: sorted(
        (jax.tree_util.keystr(p), np.shape(v))
        for p, v in jax.tree_util.tree_leaves_with_path(tree))
    for coll in ("params", "batch_stats"):
        assert structure(trunk["variables"][coll]) == structure(init[coll])


@pytest.mark.parametrize("args", [
    dict(location=None),
    dict(location=[[[]], [[]], [[]], [[]]]),
    dict(location=[[[1]], [[1, 3]], [[]], [[]]], group=[[1], [2], [1], [1]],
         pool=[[1, 2, 2], [2, 2, 2], [1, 2, 2], [1, 2, 2]],
         instantiation="softmax"),
    dict(location=[[0], [], [1], []], group=[1, 1, 2, 1]),
], ids=["none", "empty", "nested", "flat"])
def test_resolve_nonlocal_matches_jax(args):
    assert resnet3d.resolve_nonlocal(**args) == jax_r3d.resolve_nonlocal(
        **args)


def test_fresh_nonlocal_is_the_identity():
    """The zero-init BN: a block as built adds nothing."""
    block = resnet3d.Nonlocal(16, 8, (1, 2, 2)).eval()
    x = torch.randn(2, 16, 4, 6, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(block(x), x)


@pytest.mark.parametrize("head", ["keyframe", "keyframe_softmax_pooled",
                                  "basic"])
def test_heads_match_jax(head):
    """The heads on a (2, 64, 4, 3, 3) map: the per-frame head (channel-
    major flatten of a 2x2 VALID pool), the same with a full temporal
    pool and the eval softmax, and the global-pool basic head."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((2, 4, 3, 3, 64)).astype(np.float32)
    if head == "basic":
        port = resnet3d.ResNetBasicHead(64, 5)
        jax_head = jax_r3d.ResNetBasicHead(num_classes=5)
        kw = {}
    else:
        pool = 4 if head.endswith("pooled") else 1
        act = "softmax" if "softmax" in head else "none"
        port = resnet3d.KeyframeLocalizationHead(64 * 4, 3, 2, 0.5, act)
        jax_head = jax_r3d.KeyframeLocalizationHead(
            num_classes=3, spatial_pool=2, temporal_pool=pool,
            dropout_rate=0.5, act=act)
        kw = dict(temporal_pool=pool)
    kernel = rng.standard_normal(port.projection.weight.shape[::-1]) / 16
    bias = rng.standard_normal(port.projection.bias.shape) * 0.05
    with torch.no_grad():
        port.projection.weight.copy_(torch.from_numpy(kernel.T))
        port.projection.bias.copy_(torch.from_numpy(bias))
    port = place(port, "cpu")
    variables = {"params": {"projection": {"kernel": kernel.astype(np.float32),
                                           "bias": bias.astype(np.float32)}}}
    want = jax_head.apply(variables, jnp.asarray(y))
    with torch.no_grad():
        got = port(torch.from_numpy(y).permute(0, 4, 1, 2, 3), **kw)
    assert_close(got.numpy(), want, tol=1e-5)
    if head == "keyframe":
        with torch.no_grad():
            tokens = port(torch.from_numpy(y).permute(0, 4, 1, 2, 3),
                          middle=True)
        want = jax_head.apply(variables, jnp.asarray(y), middle=True)
        assert tokens.shape == (2, 4, 256)
        assert_close(tokens.numpy(), want, tol=1e-6)


def test_quant_raises_by_name():
    """``quant=True`` builds the int8 trunk (its stage convs
    ``QuantConv3d``); its forward raises, naming a scale, until it is
    calibrated (tests/test_torch_port_quant3d_trunks.py runs it)."""
    model = place(resnet3d.ResNet3D(quant=True, input_norm=None, **ARGS),
                  "cpu")
    with pytest.raises(ValueError, match="uncalibrated.*s2.block0"):
        model(torch.from_numpy(_frames(1)))
