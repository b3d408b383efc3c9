"""Port int8 stems and int8 conv (egot2x_torch.ops) against the JAX package.

The plain int8 stems -- what a CPU tensor runs and what the card holds the
CUDA kernel against -- match ``egot2x.ops.pallas_stem.fused_stem_pool_q``
in interpret mode, fed as tests/test_pallas_stem.py feeds it, and the XLA
int8 stems that ``egot2x`` ships (``nn.fused_stem.fused_rgb_stem``; the
int8 ``VisualFrontend`` stem). The bar is int8 |diff| <= 1 everywhere with
at least 99.9% of values equal: the f32 conv sums in another order (and
the Pallas kernel pre-folds 1/s into the affine), so a value within one
f32 rounding of a half-integer can flip by one quantum. Measured on these
inputs: every 2D value equal (share 1.0, n = 1 and 2, both references);
3D share 0.99998 (one value of 55,296 off by one quantum).

The int8 conv's card route (NHWC im2col + ``torch._int_mm``, which runs
on the CPU too) equals the exact plain version bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.nn.fused_stem import fused_rgb_stem  # noqa: E402
from egot2x.nn.quant import quantize_static as jax_quantize  # noqa: E402
from egot2x.nn.talknet import _packed_phase_pool, _Stem3DConv  # noqa: E402
from egot2x.ops.pallas_stem import (  # noqa: E402
    flatten_packed_kernel, fold_bn_quant, fused_stem_pool_q,
    pack_stem_kernel, s2d_input)
from egot2x_torch.ops import int8, stem  # noqa: E402

SHARE_EQUAL = 0.999


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bn_module(rng, eps):
    bn = torch.nn.BatchNorm2d(64, eps=eps).eval().requires_grad_(False)
    with torch.no_grad():
        bn.weight.copy_(_t(rng.uniform(0.5, 1.5, 64).astype(np.float32)))
        bn.bias.copy_(_t((rng.standard_normal(64) * 0.1).astype(np.float32)))
        bn.running_mean.copy_(
            _t((rng.standard_normal(64) * 0.1).astype(np.float32)))
        bn.running_var.copy_(_t(rng.uniform(0.5, 2.0, 64).astype(np.float32)))
    return bn


def _jax_bn(bn):
    return [jnp.asarray(v.detach().numpy()) for v in
            (bn.weight, bn.bias, bn.running_mean, bn.running_var)]


def _assert_int8_close(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= SHARE_EQUAL


def _trunks(rng, n):
    """n trunks' (7, 7, 3, 64) kernels, BN modules and act_max values."""
    kernels = [(rng.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32)
               for _ in range(n)]
    bns = [_bn_module(rng, 1e-5) for _ in range(n)]
    act_max = [torch.tensor(v, dtype=torch.float32) for v in (6.0, 4.5)[:n]]
    return kernels, bns, act_max


def _port_q_2d(x, kernels, bns, act_max):
    folded = [stem.fold_bn_quant(bn, a) for bn, a in zip(bns, act_max)]
    scale, bias, steps = (torch.cat(part) for part in zip(*folded))
    weight = torch.cat([_t(k.transpose(3, 2, 0, 1)) for k in kernels])
    before = stem.stem_pool_q_2d.launches
    out = stem.stem_pool_q_2d(_t(x), weight, scale, bias, steps)
    assert stem.stem_pool_q_2d.launches == before  # CPU runs the plain path
    assert out.dtype == torch.int8
    return out.numpy()


def test_fold_bn_quant_step_matches_jax():
    """s = max(act_max, 1e-6) / 127 bit for bit, and the folded BN of the
    float stem."""
    rng = np.random.default_rng(4)
    bn = _bn_module(rng, 1e-5)
    for act_max in (6.0, 0.0):
        scale, bias, s = stem.fold_bn_quant(bn, torch.tensor(act_max))
        sb = np.asarray(fold_bn_quant(*_jax_bn(bn), 1e-5,
                                      jnp.float32(act_max)))
        want_s = np.float32(max(act_max, 1e-6)) / np.float32(127.0)
        assert s.shape == (1,) and s.numpy()[0] == want_s
        # egot2x folds 1/s in: scale' = scale / s
        np.testing.assert_allclose(scale.numpy() / s.numpy(), sb[0, :64],
                                   rtol=1e-6)
        np.testing.assert_allclose(bias.numpy() / s.numpy(), sb[1, :64],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2])
def test_stem_pool_q_2d_plain_matches_pallas_interpret(n):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    kernels, bns, act_max = _trunks(rng, n)
    sb = jnp.concatenate([fold_bn_quant(*_jax_bn(bn), 1e-5,
                                        jnp.float32(float(a)))
                          for bn, a in zip(bns, act_max)], axis=1)
    w_flat = jnp.concatenate([flatten_packed_kernel(pack_stem_kernel(k), 384)
                              for k in kernels], axis=1)
    want = fused_stem_pool_q(s2d_input(jnp.asarray(x)), w_flat, sb,
                             conv_h=32, conv_w=16, tile_h=8, interpret=True)
    got = _port_q_2d(x, kernels, bns, act_max)
    assert got.shape == (2, 16, 16, 64 * n)
    _assert_int8_close(got, want)


@pytest.mark.parametrize("n", [1, 2])
def test_stem_pool_q_2d_plain_matches_xla_int8_stem(n):
    """Against ``fused_rgb_stem`` in f32: conv + BN + ReLU +
    ``quantize_static`` with each trunk's scale + ``max_pool_int8``; odd
    frame sizes exercise the ragged pool edge."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 38, 54, 3)).astype(np.float32)
    kernels, bns, act_max = _trunks(rng, n)
    stems = [dict(kernel=jnp.asarray(k), bn_scale=g, bn_bias=b, bn_mean=m,
                  bn_var=v, act_max=jnp.float32(float(a)))
             for k, bn, a in zip(kernels, bns, act_max)
             for g, b, m, v in [_jax_bn(bn)]]
    outs = fused_rgb_stem(jnp.asarray(x), stems, dtype=jnp.float32)
    want = np.concatenate([np.asarray(q) for q, _ in outs], axis=-1)
    got = _port_q_2d(x, kernels, bns, act_max)
    assert got.shape == (3, 10, 14, 64 * n)
    _assert_int8_close(got, want)


def test_stem_pool_q_3d_plain_matches_xla_int8_frontend_stem():
    """The int8 stem of egot2x's inference ``VisualFrontend``
    (nn/talknet.py:247-263): the packed stem conv, BN, ReLU,
    ``quantize_static`` and the int8 phase pool; clips of 3 frames, so the
    per-sample temporal pad reaches every frame."""
    rng = np.random.default_rng(5)
    b, t, hw = 2, 3, 48
    x = rng.uniform(-2.5, 3.5, (b, t, hw, hw)).astype(np.float32)
    k3d = (rng.standard_normal((5, 7, 7, 1, 64)) * 0.05).astype(np.float32)
    bn = _bn_module(rng, 1e-3)
    act_max = 7.0

    y = _Stem3DConv(64).apply({"params": {"kernel": jnp.asarray(k3d)}},
                              jnp.asarray(x)[..., None], packed=True)
    gamma, beta, mean, var = _jax_bn(bn)
    yv = y.reshape(*y.shape[:-1], 2, 64)
    yv = jnp.maximum((yv - mean) * (gamma / jnp.sqrt(var + 1e-3)) + beta, 0)
    y = yv.reshape(b * t, *y.shape[2:])
    yq, _ = jax_quantize(y, jnp.float32(act_max))
    want = _packed_phase_pool(yq)

    scale, bias, s = stem.fold_bn_quant(bn, torch.tensor(act_max))
    got = stem.stem_pool_q_3d(_t(x), _t(k3d.transpose(4, 3, 0, 1, 2)),
                              scale, bias, s)
    assert got.shape == (b * t, 12, 12, 64)
    _assert_int8_close(got.numpy(), want)


@pytest.mark.parametrize("fn, args", [
    (stem.stem_pool_q_2d, ((1, 16, 16, 3), (128, 3, 7, 7), (128,), (2,))),
    (stem.stem_pool_q_3d, ((1, 2, 16, 16), (64, 1, 5, 7, 7), (64,), (1,))),
])
def test_stem_q_wrapper_never_falls_back_off_cpu(fn, args):
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor, which no kernel takes, raises."""
    x, w, c, n = (torch.empty(s, device="meta") for s in args)
    with pytest.raises(ValueError, match="CUDA"):
        fn(x, w, c, c, n)


def test_int8_conv_never_falls_back_off_cpu():
    x = torch.empty((1, 8, 4, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        int8.conv2d_int8(x, torch.empty((8, 8, 3, 3), dtype=torch.int8,
                                        device="meta"), 1, 1)


@pytest.mark.parametrize("n, c, hw, o, k, stride", [
    (3, 64, 16, 64, 3, 1),     # layer1-like, channels_last input
    (2, 128, 8, 256, 3, 2),    # a strided 3x3
    (1, 128, 4, 256, 1, 2),    # a 1x1 projection: 4 rows, padded to 17
    (2, 12, 5, 20, 3, 1),      # widths that break _int_mm's multiples of 8
])
def test_im2col_int_mm_is_exact(n, c, hw, o, k, stride):
    rng = np.random.default_rng(n * 100 + c)
    x = _t(rng.integers(-127, 128, (n, c, hw, hw), dtype=np.int8))
    x = x.contiguous(memory_format=torch.channels_last)
    w = _t(rng.integers(-127, 128, (o, c, k, k), dtype=np.int8))
    got = int8.im2col_int_mm(x, w, stride, k // 2)
    want = int8.conv2d_int8_plain(x, w, stride, k // 2)
    assert got.dtype == want.dtype == torch.int32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the plain version is the JAX package's integer conv
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), (stride, stride),
        [(k // 2, k // 2)] * 2, dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(want.numpy(), np.asarray(ref))


def test_max_pool_int8_matches_jax():
    from egot2x.nn.quant import max_pool_int8

    x = np.random.default_rng(6).integers(-128, 128, (2, 7, 10, 5),
                                          dtype=np.int8)
    want = max_pool_int8(jnp.asarray(x), (3, 3), (2, 2), [(1, 1), (1, 1)])
    np.testing.assert_array_equal(int8.max_pool_int8(_t(x)).numpy(),
                                  np.asarray(want))
