"""The port's int8 3D conv (``ops/int8.py::conv3d_int8``) and
``nn/quant.py::QuantConv3d`` against the JAX package's ``QuantConv3D``.

The three convs of the HOI trunks' int8 path, each on a seeded random f32
kernel and input (numpy): a bottleneck ``a`` (3x1x1, T padded by 1), a
``b`` (1x3x3, stride (1, 2, 2), H and W padded by 1) and a ``branch1``
(1x1x1, stride (1, 2, 2), no padding). JAX calibrates its conv
(``calibrate=True``, the ``quant`` collection), and the port conv takes
that scale and the kernel through the weight bridge's layouts.

Tolerances: the int8 weights and the int32 accumulators are exact integer
arithmetic on both sides: equal bit for bit; the dequantized outputs are
the same f32 products, rtol 1e-6 (measured max |diff| 0: equal). The card
route (NTHWC im2col + ``torch._int_mm``, which runs on the CPU too) is held
bit for bit against the plain float64 conv with random int8 weights (a
transposed K order fails it), at widths that break ``_int_mm``'s
multiples of 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.nn.quant import QuantConv3D  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.nn.quant import QuantConv3d, quantize_weight  # noqa: E402
from egot2x_torch.ops import int8  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

DN = ("NTHWC", "THWIO", "NTHWC")
# name: (kernel, stride, padding), as nn/resnet3d.py builds them
CONVS = {"a_t3": ((3, 1, 1), (1, 1, 1), (1, 0, 0)),
         "b_stride2": ((1, 3, 3), (1, 2, 2), (0, 1, 1)),
         "branch1_stride2": ((1, 1, 1), (1, 2, 2), (0, 0, 0))}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_quant_conv3d_matches_jax(name):
    kernel, stride, pad = CONVS[name]
    rng = np.random.default_rng(len(name))
    c, o = 24, 40
    k = (rng.standard_normal((*kernel, c, o)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((2, 4, 9, 9, c)) * 2).astype(np.float32)
    jax_conv = QuantConv3D(o, kernel, strides=stride,
                           padding=[(p, p) for p in pad])
    want_float, mutated = jax_conv.apply(
        {"params": {"kernel": k},
         "quant": {"act_max": np.float32(0)}},
        jnp.asarray(x), calibrate=True, mutable=["quant"])
    variables = {"params": {"kernel": k}, "quant": mutated["quant"]}
    want = np.asarray(jax_conv.apply(variables, jnp.asarray(x)))

    conv = QuantConv3d(c, o, kernel, stride, pad)
    conv.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(
            bridge._TO_TORCH["conv3d"]([k]))),
        "act_max": torch.tensor(float(mutated["quant"]["act_max"]))})
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)   # NCTHW view
    with torch.no_grad():
        got = conv(xt).permute(0, 2, 3, 4, 1).numpy()
        conv.calibrating = True   # the float path, as JAX's calibrate
        got_float = conv(xt).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_float, np.asarray(want_float),
                               rtol=1e-4, atol=1e-5)

    # the int8 weight and the accumulator, against XLA's int32 conv
    s_w = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2, 3)), 1e-12) / 127.0
    wq_jax = jnp.round(k / s_w).astype(jnp.int8)
    wq, got_s = quantize_weight(conv.weight.detach())
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s_w))
    np.testing.assert_array_equal(wq.permute(2, 3, 4, 1, 0).numpy(),
                                  np.asarray(wq_jax))
    s_act = jnp.maximum(mutated["quant"]["act_max"], 1e-6) / 127.0
    xq = jnp.clip(jnp.round(jnp.asarray(x) / s_act), -127, 127).astype(
        jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, wq_jax, stride, [(p, p) for p in pad], dimension_numbers=DN,
        preferred_element_type=jnp.int32)
    ours = int8.conv3d_int8(torch.from_numpy(np.array(xq)).permute(
        0, 4, 1, 2, 3), wq, stride, pad)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(acc))


def test_im2col_int_mm_3d_is_exact_and_refuses_the_rest():
    """The card route on the CPU, bit for bit against the plain version:
    the three kernels at widths 12 -> 20 (K 36, 108, 12; N 20: padded),
    the 8-channel fast-pathway widths and a 16 -> 24 1x1x1 (a view, no
    copy). What it does not take raises: non-int8 operands, a device that
    is neither the CPU nor CUDA, a dilated ``QuantConv3d``."""
    g = torch.Generator().manual_seed(0)
    cases = [(12, 20, *CONVS[n]) for n in sorted(CONVS)] + [
        (8, 8, (3, 1, 1), 1, (1, 0, 0)), (8, 8, (1, 3, 3), 1, (0, 1, 1)),
        (16, 24, (1, 1, 1), 1, 0)]
    for c, o, kernel, stride, pad in cases:
        x = torch.randint(-127, 128, (2, c, 4, 9, 9), dtype=torch.int8,
                          generator=g)
        x = x.contiguous(memory_format=torch.channels_last_3d)
        w = torch.randint(-127, 128, (o, c, *kernel), dtype=torch.int8,
                          generator=g)
        got = int8.im2col_int_mm_3d(x, w, stride, pad)
        want = int8.conv3d_int8_plain(x, w, stride, pad)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want), (c, o, kernel, stride, pad)
        assert torch.equal(int8.conv3d_int8(x, w, stride, pad), want)
    with pytest.raises(TypeError, match="int8"):
        int8.conv3d_int8(x.float(), w, 1, 0)
    with pytest.raises(ValueError, match="CUDA"):
        int8.conv3d_int8(x.to("meta"), w.to("meta"), 1, 0)
    with pytest.raises(ValueError, match="dilation"):
        QuantConv3d(8, 8, (1, 3, 3), padding=(0, 2, 2), dilation=(1, 2, 2))
