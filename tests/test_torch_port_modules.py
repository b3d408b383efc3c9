"""Port modules against their JAX counterparts, through the weight bridge.

Each module gets one variable tree (numpy, JAX layout, drawn from a seed
by ``bridge.random_jax_variables``) that both packages load, and the same
inputs. Both run f32 on the CPU with full-precision matmuls (the JAX side
jitted): outputs agree
to rtol = atol = 1e-4 (the differences are summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.nn import common as jax_common  # noqa: E402
from egot2x.nn.resnet2d import ResNet2D as JaxResNet2D  # noqa: E402
from egot2x.nn.talknet import TalkNetModel as JaxTalkNet  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.nn import common  # noqa: E402
from egot2x_torch.nn.resnet2d import ResNet2D  # noqa: E402
from egot2x_torch.nn.talknet import TalkNetModel  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _shared(port, seed):
    variables = bridge.random_jax_variables(port, seed)
    bridge.load_jax_variables(port, variables)
    return port.eval(), variables


def _abstract_init(model, *args):
    return jax.eval_shape(lambda *a: model.init(jax.random.key(0), *a),
                          *args)


def _structure(tree):
    return sorted((jax.tree_util.keystr(p), np.shape(v)) for p, v in
                  jax.tree_util.tree_leaves_with_path(tree))


def test_resnet2d_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    jax_model = JaxResNet2D(num_classes=256)
    port, variables = _shared(ResNet2D(num_classes=256), seed=0)
    init = _abstract_init(jax_model, jnp.asarray(x))
    assert _structure(variables) == _structure(
        {k: init[k] for k in ("params", "batch_stats")})
    ours = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        theirs = port(torch.from_numpy(x)).numpy()
    assert theirs.shape == (3, 256)
    np.testing.assert_allclose(theirs, ours, **TOL)


def test_talknet_matches_jax():
    """Two clips of 6 frames: the per-sample temporal pad of the 3D stem,
    the A/V time alignment (4T/4 audio steps) and all three outputs."""
    rng = np.random.default_rng(1)
    mfcc = rng.standard_normal((2, 24, 13)).astype(np.float32)
    faces = rng.uniform(0, 255, (2, 6, 64, 64)).astype(np.float32)
    port, variables = _shared(TalkNetModel(), seed=1)
    ours = jax.jit(JaxTalkNet().apply)(variables, jnp.asarray(mfcc),
                                       jnp.asarray(faces))
    with torch.no_grad():
        theirs = port(torch.from_numpy(mfcc), torch.from_numpy(faces))
    for a, b, d in zip(theirs, ours, (256, 128, 128)):
        assert a.shape == (2, 6, d)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_transformer_encoder_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    jax_model = jax_common.TransformerEncoder(
        num_layers=2, d_model=32, num_heads=4, dim_feedforward=64)
    port, variables = _shared(common.TransformerEncoder(2, 32, 4, 64), seed=2)
    ours = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        theirs = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(theirs, ours, **TOL)


def test_positional_encoding_matches_jax():
    """atol 1e-4: at position 999 the f32 argument of sin/cos has an ulp of
    6e-5, and XLA and torch reduce it differently."""
    ours = np.asarray(jax_common.sinusoidal_positional_encoding(1000, 128))
    theirs = common.sinusoidal_positional_encoding(1000, 128).numpy()
    np.testing.assert_allclose(theirs, ours, rtol=0, atol=1e-4)


def test_bridge_round_trip_is_exact():
    port, variables = _shared(TalkNetModel(), seed=3)
    back = bridge.to_jax_variables(port)
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(jax.tree_util.keystr, got)) == \
        sorted(map(jax.tree_util.keystr, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)


def test_bridge_rejects_a_drifted_name():
    port, variables = _shared(common.TransformerEncoder(1, 32, 4, 64), seed=4)
    layer = variables["params"]["layers_0"]
    layer["linear_one"] = layer.pop("linear1")
    with pytest.raises(KeyError):
        bridge.from_jax_variables(port, variables)
