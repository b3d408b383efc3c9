"""Port stem (egot2x_torch.ops.stem) against the TPU kernel it replaces.

The plain PyTorch stems -- what a CPU tensor runs and what the card holds
the CUDA kernel against -- match ``egot2x.ops.pallas_stem.fused_stem_pool``
run in interpret mode, as tests/test_pallas_stem.py runs it, to the same
rtol = atol = 1e-4 that file holds the Pallas kernel to.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.ops.pallas_stem import (  # noqa: E402
    flatten_packed_kernel, fold_bn, fused_stem_pool, pack_stem_kernel,
    pack_stem_kernel_3d, s2d_input, s2d_input_3d)
from egot2x_torch.ops import stem  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401


def _bn(rng):
    gamma = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    beta = (rng.standard_normal(64) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(64) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return gamma, beta, mean, var


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_fold_bn_matches_jax(eps):
    bn = _bn(np.random.default_rng(3))
    sb = np.asarray(fold_bn(*map(jnp.asarray, bn), eps))
    scale, bias = stem.fold_bn(*map(_t, bn), eps)
    np.testing.assert_allclose(scale.numpy(), sb[0, :64], rtol=1e-6)
    np.testing.assert_allclose(bias.numpy(), sb[1, :64], rtol=1e-6,
                               atol=1e-7)


def test_stem_pool_2d_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    hw = 64
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    k = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    bn = _bn(rng)
    sb = fold_bn(*map(jnp.asarray, bn), 1e-5)
    w_flat = flatten_packed_kernel(pack_stem_kernel(k), 384)
    ref = fused_stem_pool(s2d_input(jnp.asarray(x)), w_flat, sb,
                          conv_h=hw // 2, conv_w=hw // 4, tile_h=8,
                          interpret=True)

    scale, bias = stem.fold_bn(*map(_t, bn), 1e-5)
    before = stem.stem_pool_2d.launches
    out = stem.stem_pool_2d(_t(x), _t(k.transpose(3, 2, 0, 1)), scale, bias)
    assert out.shape == (2, hw // 4, hw // 4, 64)
    assert stem.stem_pool_2d.launches == before  # CPU runs the plain path
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_stem_pool_3d_plain_matches_pallas_interpret():
    """Per-sample temporal padding: (2, 6) clips, the 5-tap window never
    reaches across the clip boundary."""
    rng = np.random.default_rng(1)
    b, t, hw = 2, 6, 64
    x = rng.standard_normal((b, t, hw, hw)).astype(np.float32)
    k3d = (rng.standard_normal((5, 7, 7, 1, 64)) * 0.1).astype(np.float32)
    bn = _bn(rng)
    sb = fold_bn(*map(jnp.asarray, bn), 1e-3)
    w_flat = flatten_packed_kernel(pack_stem_kernel_3d(k3d), 512)
    ref = fused_stem_pool(s2d_input_3d(jnp.asarray(x)), w_flat, sb,
                          conv_h=hw // 2, conv_w=hw // 4, tile_h=8,
                          interpret=True)

    scale, bias = stem.fold_bn(*map(_t, bn), 1e-3)
    out = stem.stem_pool_3d(_t(x), _t(k3d.transpose(4, 3, 0, 1, 2)), scale,
                            bias)
    assert out.shape == (b * t, hw // 4, hw // 4, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n, pooled", [(224, 56), (112, 28), (64, 16),
                                       (70, 18), (9, 3)])
def test_pooled_size_matches_plain(n, pooled):
    x = torch.zeros(1, n, n + 2, 3)
    out = stem.stem_pool_2d_plain(x, torch.zeros(64, 3, 7, 7),
                                  torch.ones(64), torch.zeros(64))
    assert stem.pooled_size(n) == pooled
    assert out.shape == (1, pooled, stem.pooled_size(n + 2), 64)


@pytest.mark.parametrize("fn, shape, wshape", [
    (stem.stem_pool_2d, (1, 16, 16, 3), (64, 3, 7, 7)),
    (stem.stem_pool_3d, (1, 2, 16, 16), (64, 1, 5, 7, 7)),
])
def test_stem_wrapper_never_falls_back_off_cpu(fn, shape, wshape):
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor, which no kernel takes, raises."""
    x = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(x, torch.empty(wshape, device="meta"),
           torch.empty(64, device="meta"), torch.empty(64, device="meta"))
