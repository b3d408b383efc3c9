"""The port's flash attention and its route against the JAX package.

``egot2x_torch.ops.flash.flash_attention_plain`` (what the CUDA kernel is
held against on the card) against the Pallas kernel in interpret mode, at
the shapes of tests/test_pallas_attention.py and at TalkNet's head dims 16
and 32, to that file's tolerance (rtol 1e-4, atol 1e-5). The route of
``ops/attention.py``: flash exactly when q and k both hold >= 2048 tokens
on the card, at any head dim (routed attention at D 129 and 256 against
the Pallas kernel), never on the CPU, checked without a launch; the flash
wrapper refuses inputs that need grad, routed or not. TalkNet's
cross-attention layer at T = 2048 (d 128, 8 heads), plain and through the
route, against the JAX layer at rtol = atol = 1e-4. Both sides run f32 on
the CPU with full-precision matmuls; the JAX side is jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.nn.talknet import CrossAttentionLayer as JaxCrossAttention  # noqa: E402
from egot2x.ops.pallas_attention import flash_attention as jax_flash  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.nn.talknet import CrossAttentionLayer  # noqa: E402
from egot2x_torch.ops import attention, flash  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

FLASH_TOL = dict(rtol=1e-4, atol=1e-5)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, bh, n, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((bh, n, d), (bh, s, d), (bh, s, d))]


@pytest.mark.parametrize("n, s, d", [(128, 128, 64), (300, 500, 64),
                                     (257, 130, 40), (96, 160, 16),
                                     (160, 96, 32)])
def test_flash_plain_matches_jax_interpret(n, s, d):
    q, k, v = _qkv(0, 2, n, s, d)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=128, block_k=128,
                                interpret=True))
    launches = flash.flash_attention.launches
    got = flash.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert flash.flash_attention.launches == launches  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)


def test_flash_plain_reads_the_heads_last_layout():
    """(B, N, H, D) in gives the (BH, N, D) result in that layout."""
    q, k, v = _qkv(1, 6, 40, 24, 16)
    flat = flash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    heads_last = [torch.from_numpy(x).reshape(2, 3, *x.shape[1:])
                  .transpose(1, 2) for x in (q, k, v)]
    out = flash.flash_attention_plain(*heads_last)
    assert out.shape == (2, 40, 3, 16) and out.is_contiguous()
    torch.testing.assert_close(out.transpose(1, 2).reshape(6, 40, 16), flat,
                               rtol=0, atol=0)


def test_flash_checks_what_the_kernel_takes():
    q = torch.zeros(2, 8, 16)
    assert flash._geometry(q, q, q) == (2, 1, 8, 8, 16)
    assert flash._geometry(*[torch.zeros(2, 8, 3, 16)] * 3) == (2, 3, 8, 8,
                                                                  16)
    bad = [(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)),    # D differs
           (q, torch.zeros(3, 8, 16), torch.zeros(3, 8, 16)),    # BH differs
           (torch.zeros(2, 8, 0),) * 3,                          # D 0
           (q, q, q.double())]                                   # dtypes
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            flash._geometry(*args)
    with pytest.raises(ValueError, match="contiguous last axis"):
        strided = torch.zeros(2, 16, 8).transpose(1, 2)
        flash._geometry(strided, strided, strided)


def test_route_takes_flash_exactly_at_2048_on_the_card():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert attention.FLASH_MIN_TOKENS == 2048
    assert attention.routes_to_flash(cuda, 2048, 2048)
    assert attention.routes_to_flash(cuda, 4096, 2048)
    assert not attention.routes_to_flash(cuda, 2047, 2048)
    assert not attention.routes_to_flash(cuda, 2048, 2047)
    assert not attention.routes_to_flash(cpu, 2048, 2048)
    assert not attention.routes_to_flash(cpu, 8192, 8192)


def test_attention_asks_the_route_with_device_and_lengths(monkeypatch):
    """The route looks at the device and the lengths only: neither the
    head dim nor autograd keeps attention off the kernel."""
    asked = []
    monkeypatch.setattr(attention, "routes_to_flash",
                        lambda *a: asked.append(a) or False)
    q = torch.zeros(1, 3, 2, 200)
    w = torch.zeros(1, 5, 2, 200, requires_grad=True)
    attention.dot_product_attention(q, q, q)
    attention.dot_product_attention(q, w, w)
    cpu = torch.device("cpu")
    assert asked == [(cpu, 3, 3), (cpu, 3, 5)]


@pytest.mark.parametrize("d", [129, 256])
def test_routed_attention_at_wide_head_dims_matches_jax(monkeypatch, d):
    """Past D 128 (the Pallas kernel pads D to a multiple of 128) the
    routed call reaches the flash wrapper, whose plain version matches
    the Pallas kernel in interpret mode."""
    q, k, v = _qkv(d, 2, 64, 96, d)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=128, block_k=128,
                                interpret=True))
    calls = _route_everything(monkeypatch)
    heads_last = [torch.from_numpy(x).unsqueeze(0).transpose(1, 2)
                  for x in (q, k, v)]   # (1, N, 2, D) views
    got = attention.dot_product_attention(*heads_last)
    assert calls == [(1, 64, 2, d)]
    np.testing.assert_allclose(got.transpose(1, 2)[0].numpy(), want,
                               **FLASH_TOL)


def test_routed_attention_that_needs_grad_raises(monkeypatch):
    """The kernel has no backward: attention that autograd differentiates
    and the route sends to it raises instead of dropping the gradient;
    under no_grad it runs."""
    monkeypatch.setattr(attention, "routes_to_flash", lambda *a: True)
    q = torch.zeros(1, 6, 2, 8)
    w = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        attention.dot_product_attention(q, w, q)
    with torch.no_grad():
        assert attention.dot_product_attention(q, w, q).shape == q.shape


def test_attention_with_grad_keeps_its_gradient():
    """Attention that requires grad and is not routed (the CPU) is
    differentiable, with the gradient of the plain flash version."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 9, 2, 8))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    attention.dot_product_attention(q, k, v).sum().backward()
    ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    flash.flash_attention_plain(*ref).sum().backward()
    for x, r in zip((q, k, v), ref):
        torch.testing.assert_close(x.grad, r.grad, rtol=1e-5, atol=1e-6)


def test_flash_wrapper_refuses_inputs_that_need_grad():
    """The kernel has no backward: its wrapper raises rather than return
    an output whose gradient was dropped (on the CPU as on the card)."""
    q = torch.zeros(2, 8, 16)
    w = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        flash.flash_attention(q, w, q)
    with torch.no_grad():
        assert flash.flash_attention(q, w, q).shape == q.shape


def _route_everything(monkeypatch):
    """Send every attention call down the flash route (CPU tensors take
    its plain version) and count the calls."""
    calls = []

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return flash.flash_attention_plain(q, k, v)

    monkeypatch.setattr(attention, "routes_to_flash", lambda *a: True)
    monkeypatch.setattr(attention.flash, "flash_attention", spy)
    return calls


def test_routed_attention_matches_the_plain_path(monkeypatch):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 4, 8))
                                .astype(np.float32)) for n in (33, 17, 17))
    plain = attention.dot_product_attention(q, k, v)
    calls = _route_everything(monkeypatch)
    routed = attention.dot_product_attention(q, k, v)
    assert calls == [(2, 33, 4, 8)]
    torch.testing.assert_close(routed, plain, **FLASH_TOL)


@pytest.fixture(scope="module")
def cross_layer():
    """(JAX layer output, port layer, src, tar) at T = 2048."""
    rng = np.random.default_rng(3)
    src, tar = (rng.standard_normal((1, 2048, 128)).astype(np.float32)
                for _ in range(2))
    port = CrossAttentionLayer(128, 8)
    variables = bridge.random_jax_variables(port, seed=4)
    bridge.load_jax_variables(port, variables)
    want = jax.jit(JaxCrossAttention(128, 8).apply)(
        variables, jnp.asarray(src), jnp.asarray(tar))
    return np.asarray(want), port.eval(), src, tar


@pytest.mark.parametrize("routed", [False, True])
def test_cross_attention_at_2048_matches_jax(cross_layer, monkeypatch,
                                             routed):
    want, port, src, tar = cross_layer
    calls = _route_everything(monkeypatch) if routed else []
    with torch.no_grad():
        got = port(torch.from_numpy(src), torch.from_numpy(tar))
    assert calls == ([(1, 2048, 8, 16)] if routed else [])
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
