"""Card tests: the hand-written CUDA stem kernels against their plain
versions, the int8 conv's ``torch._int_mm`` route against its exact plain
version, and small flagships (float and int8) on the card against the CPU.

Marked ``cuda``; each test skips when the process sees no CUDA card. This
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs on its own. tests/conftest.py imports JAX, hence ``--noconftest``;
that skips the conftest's marker registration, so ``-o`` registers
``cuda`` on the command line:

    python -m pytest --noconftest -o "markers=cuda: needs a CUDA card" \
        --strict-markers -p no:cacheprovider -q tests/test_torch_port_cuda.py

Tolerances: f32 kernel vs the plain f32 version (cuDNN with TF32 off),
rtol = atol = 1e-4 as tests/test_pallas_stem.py holds the Pallas kernel;
bf16 kernel vs the plain f32 version of the same bf16-rounded inputs,
rtol = atol = 1e-2 (the kernel rounds its f32 result to bf16 once: 2^-8
relative). int8 stems: |diff| <= 1 quantum everywhere and >= 99.9% equal
(the f32 conv sums in another order than cuDNN, so a value within one
rounding of a half-integer flips). int8 conv: bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x_torch.ops import int8, stem  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, wshape, device):
    w = torch.from_numpy((rng.standard_normal(wshape) * 0.1)
                         .astype(np.float32)).to(device)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    beta = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32))
    mean = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32))
    var = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(np.float32))
    scale, bias = stem.fold_bn(gamma, beta, mean, var, 1e-5)
    return w, scale.to(device), bias.to(device)


TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 224, 224), (2, 64, 64), (2, 70, 90),
                                   (1, 9, 17)])
def test_stem_pool_2d_kernel_matches_plain(cuda, dtype, shape):
    rng = np.random.default_rng(0)
    n, h, w = shape
    x = torch.from_numpy(rng.standard_normal((n, h, w, 3)).astype(np.float32))
    x = x.to(cuda).to(dtype)
    weight, scale, bias = _params(rng, (64, 3, 7, 7), cuda)
    before = stem.stem_pool_2d.launches
    out = stem.stem_pool_2d(x, weight, scale, bias)
    torch.cuda.synchronize()
    assert stem.stem_pool_2d.launches == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    ref = stem.stem_pool_2d_plain(x.float(), weight, scale, bias)
    assert out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 112, 112), (3, 2, 40, 52),
                                   (1, 1, 16, 16)])
def test_stem_pool_3d_kernel_matches_plain(cuda, dtype, shape):
    """Covers clips shorter than the 5-tap window and the per-sample
    temporal zero-pad."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-2, 2, shape).astype(np.float32))
    x = x.to(cuda).to(dtype)
    weight, scale, bias = _params(rng, (64, 1, 5, 7, 7), cuda)
    before = stem.stem_pool_3d.launches
    out = stem.stem_pool_3d(x, weight, scale, bias)
    torch.cuda.synchronize()
    assert stem.stem_pool_3d.launches == before + 1
    ref = stem.stem_pool_3d_plain(x.float(), weight, scale, bias)
    assert out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])


def test_stem_kernel_rejects_what_it_does_not_take(cuda):
    weight, scale, bias = _params(np.random.default_rng(2), (64, 3, 7, 7),
                                  cuda)
    x = torch.zeros(1, 32, 32, 3, device=cuda)
    with pytest.raises(TypeError):
        stem.stem_pool_2d(x.half(), weight, scale, bias)
    with pytest.raises(ValueError):
        stem.stem_pool_2d(x.transpose(1, 2), weight, scale, bias)
    with pytest.raises(ValueError):
        stem.stem_pool_2d(x, weight.cpu(), scale, bias)


def test_flagship_on_card_matches_cpu(cuda):
    """A small flagship (D=64, 1 layer) on the card and on the CPU, same
    weights: the stems go through the kernel (3 launches per forward)."""
    from egot2x_torch.core import bridge
    from egot2x_torch.core.registry import build_model

    kw = dict(hidden_dim=64, num_heads=4, num_layers=1)
    gpu = build_model("TaskFusionMFTransformer3Task", **kw)
    cpu = build_model("TaskFusionMFTransformer3Task", device="cpu", **kw)
    variables = bridge.random_jax_variables(cpu, seed=0)
    bridge.load_jax_variables(cpu, variables)
    bridge.load_jax_variables(gpu, variables)
    rng = np.random.default_rng(3)
    inputs = [
        torch.from_numpy(rng.standard_normal((2, 4, 64, 64, 3))
                         .astype(np.float32)),
        torch.from_numpy(rng.uniform(0, 255, (2, 4, 112, 112))
                         .astype(np.float32)),
        None,
        torch.from_numpy(rng.standard_normal((2, 16, 13)).astype(np.float32)),
    ]
    counts = stem.stem_pool_2d.launches, stem.stem_pool_3d.launches
    with torch.no_grad():
        want = cpu(*inputs)
        got = gpu(*[None if v is None else v.to(cuda) for v in inputs])
    assert (stem.stem_pool_2d.launches - counts[0],
            stem.stem_pool_3d.launches - counts[1]) == (2, 1)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def _q_params(rng, n, device):
    """n trunks stacked: weight (64 n, 3, 7, 7), scale, bias (64 n,) and
    steps (n,) that put the post-ReLU map over the int8 range."""
    parts = [_params(rng, (64, 3, 7, 7), device) for _ in range(n)]
    weight, scale, bias = (torch.cat(p) for p in zip(*parts))
    steps = torch.tensor([0.02, 0.035][:n], device=device)
    return weight, scale, bias, steps


def _assert_int8_close(got, want):
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("shape", [(3, 224, 224), (2, 70, 90), (1, 9, 17)])
def test_stem_pool_q_2d_kernel_matches_plain(cuda, dtype, n, shape):
    rng = np.random.default_rng(4)
    b, h, w = shape
    x = torch.from_numpy(rng.standard_normal((b, h, w, 3)).astype(np.float32))
    x = x.to(cuda).to(dtype)
    weight, scale, bias, steps = _q_params(rng, n, cuda)
    before = stem.stem_pool_q_2d.launches
    out = stem.stem_pool_q_2d(x, weight, scale, bias, steps)
    torch.cuda.synchronize()
    assert stem.stem_pool_q_2d.launches == before + 1
    assert out.is_contiguous() and out.shape[-1] == 64 * n
    _assert_int8_close(out, stem.stem_pool_q_2d_plain(x, weight, scale, bias,
                                                      steps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 112, 112), (3, 2, 40, 52),
                                   (1, 1, 16, 16)])
def test_stem_pool_q_3d_kernel_matches_plain(cuda, dtype, shape):
    """Clips of 1 and 2 frames take the per-sample temporal pad."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-2, 2, shape).astype(np.float32))
    x = x.to(cuda).to(dtype)
    weight, scale, bias = _params(rng, (64, 1, 5, 7, 7), cuda)
    steps = torch.tensor([0.03], device=cuda)
    before = stem.stem_pool_q_3d.launches
    out = stem.stem_pool_q_3d(x, weight, scale, bias, steps)
    torch.cuda.synchronize()
    assert stem.stem_pool_q_3d.launches == before + 1
    _assert_int8_close(out, stem.stem_pool_q_3d_plain(x, weight, scale, bias,
                                                      steps))


def test_stem_q_kernel_rejects_what_it_does_not_take(cuda):
    weight, scale, bias, steps = _q_params(np.random.default_rng(6), 1, cuda)
    x = torch.zeros(1, 32, 32, 3, device=cuda)
    for bad in (torch.int8, torch.float64):
        with pytest.raises(TypeError):
            stem.stem_pool_q_2d(x.to(bad), weight, scale, bias, steps)
    w2, scale2, bias2, steps2 = _q_params(np.random.default_rng(7), 2, cuda)
    with pytest.raises(ValueError):   # 96 output channels: not 64 n
        stem.stem_pool_q_2d(x, w2[:96], scale2[:96], bias2[:96], steps)
    with pytest.raises(ValueError):   # 3 trunks
        stem.stem_pool_q_2d(x, weight.repeat(3, 1, 1, 1), scale.repeat(3),
                            bias.repeat(3), steps.repeat(3))
    with pytest.raises(ValueError):   # one step for two trunks
        stem.stem_pool_q_2d(x, w2, scale2, bias2, steps)
    stem.stem_pool_q_2d(x, w2, scale2, bias2, steps2)   # and the right call


@pytest.mark.parametrize("n, c, hw, o, k, stride", [
    (480, 64, 56, 64, 3, 1),      # layer1 at the main path's 480 frames
    (480, 256, 7, 512, 3, 2),     # layer4's strided conv
    (2, 128, 4, 256, 1, 2),       # a 1x1 projection of 8 rows
    (2, 12, 5, 20, 3, 1),         # widths off _int_mm's multiples of 8
])
def test_int8_conv_matches_plain_bit_for_bit(cuda, n, c, hw, o, k, stride):
    rng = np.random.default_rng(c + o)
    x = torch.from_numpy(rng.integers(-127, 128, (n, c, hw, hw),
                                      dtype=np.int8)).to(cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.integers(-127, 128, (o, c, k, k),
                                      dtype=np.int8)).to(cuda)
    before = int8.conv2d_int8.launches
    got = int8.conv2d_int8(x, w, stride, k // 2)
    assert int8.conv2d_int8.launches == before + 1
    want = int8.conv2d_int8_plain(x, w, stride, k // 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_flagship_on_card_matches_cpu(cuda):
    """A small int8 flagship (D=64, 1 layer, fuse_stems, bf16 compute),
    calibrated on the card; the CPU model loads its calibrated state. Per
    forward: one fused int8 RGB stem, one int8 TalkNet stem, 57 int8
    convs. Logits within the JAX package's bf16 int8 bar
    (tests/test_u8_input.py:122), scaled by the logits as the float check
    is: 5e-2 (1 + max |logit|)."""
    from egot2x_torch.core import bridge
    from egot2x_torch.core.registry import build_model
    from egot2x_torch.nn.quant import calibrate

    kw = dict(hidden_dim=64, num_heads=4, num_layers=1, quant=True,
              fuse_stems=True, dtype=torch.bfloat16)
    gpu = build_model("TaskFusionMFTransformer3Task", **kw)
    cpu = build_model("TaskFusionMFTransformer3Task", device="cpu", **kw)
    bridge.load_jax_variables(gpu, bridge.random_jax_variables(gpu, seed=0))
    rng = np.random.default_rng(7)
    inputs = [
        torch.from_numpy(rng.standard_normal((2, 4, 64, 64, 3))
                         .astype(np.float32)),
        torch.from_numpy(rng.uniform(0, 255, (2, 4, 112, 112))
                         .astype(np.float32)),
        None,
        torch.from_numpy(rng.standard_normal((2, 16, 13)).astype(np.float32)),
    ]
    on_card = [None if v is None else v.to(cuda) for v in inputs]
    calibrate(gpu, *on_card)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    counts = (stem.stem_pool_q_2d.launches, stem.stem_pool_q_3d.launches,
              int8.conv2d_int8.launches)
    with torch.no_grad():
        got = gpu(*on_card).float().cpu()
        want = cpu(*inputs).float()
    assert (stem.stem_pool_q_2d.launches - counts[0],
            stem.stem_pool_q_3d.launches - counts[1],
            int8.conv2d_int8.launches - counts[2]) == (1, 1, 57)
    assert bool(torch.isfinite(got).all())
    bound = 5e-2 * (1 + float(want.abs().max()))
    assert float((got - want).abs().max()) <= bound
