"""Card tests: the hand-written CUDA stem kernel against its plain version.

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
relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x_torch.ops import stem  # noqa: E402

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
