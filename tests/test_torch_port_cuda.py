"""Card tests: the hand-written CUDA stem and flash-attention kernels
against their plain versions, the int8 conv's ``torch._int_mm`` route
against its exact plain version, the attention route on the card (any
head dim launches the kernel, attention that needs grad raises), small
flagships
(float and int8) on the card against the CPU, and a frozen Stage-II train
step on the card against the CPU (loss 1e-4 relative, gradient cosines
>= 0.99999). The float stem's training variant and backward kernel
against their plain versions, the differentiable stem against autograd
of the plain version, the int8 stems' refusal of inputs that need grad,
and ``nofreeze`` / ``remat`` train steps on the card against the CPU.
Stage I: stems in training mode launch no kernel (batch statistics, as
library ops) and in eval mode one; each Stage-I task's step on the card
against the CPU. EgoT2-g: masked and causal attention never launch flash,
the prompt encoder on a 700-frame ASD track's 2100 tokens does (once a
layer), and the causal decoder on the card against the CPU. The int8 3D
conv bit for bit against its plain version at the HOI trunks' shapes, and
an int8 ts_pnr on the card against the CPU.

Marked ``cuda``; each test skips when the process sees no CUDA card. This
file imports neither JAX nor the JAX package, so on a machine without JAX
it runs on its own. tests/conftest.py imports JAX, hence ``--noconftest``;
that skips the conftest's marker registration, so ``-o`` registers
``cuda`` on the command line:

    python -m pytest --noconftest -o "markers=cuda: needs a CUDA card" \
        --strict-markers -p no:cacheprovider -q tests/test_torch_port_cuda.py

Tolerances: f32 kernel vs the plain f32 version (cuDNN with TF32 off),
rtol = atol = 1e-4 as tests/test_pallas_stem.py holds the Pallas kernel
(on raw 0-255 frames and at 1e6 against the plain version in f64);
bf16 kernel vs the plain f32 version of the same bf16-rounded inputs,
rtol = atol = 1e-2 (the kernel rounds its f32 result to bf16 once: 2^-8
relative). int8 stems: |diff| <= 1 quantum everywhere and >= 99.9% equal
(the f32 conv sums in another order than cuDNN, so a value within one
rounding of a half-integer flips). int8 convs: bit for bit. Flash kernel vs
its plain version on the same inputs: f32 rtol 1e-4, atol 1e-5 as
tests/test_pallas_attention.py holds the Pallas kernel; bf16 1e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x_torch.ops import attention, flash, int8, stem  # noqa: E402

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
                                   (1, 9, 17), (2, 112, 112), (2, 200, 168),
                                   (2, 97, 131)])
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
                                   (1, 1, 16, 16), (1, 7, 112, 112),
                                   (5, 7, 40, 52)])
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


def _stem_inputs(kind, x_host, cuda, seed):
    """(wrapper, plain, x on the card, weight, scale, bias) of a float stem
    with weights N(0, 1 / fan-in)."""
    rng = np.random.default_rng(seed)
    wshape, fan = ((64, 3, 7, 7), 147) if kind == "2d" else ((64, 1, 5, 7, 7),
                                                              245)
    weight, scale, bias = _params(rng, wshape, cuda)
    weight = weight * (10.0 / np.sqrt(fan))      # _params draws 0.1 N(0, 1)
    fns = ((stem.stem_pool_2d, stem.stem_pool_2d_plain) if kind == "2d"
           else (stem.stem_pool_3d, stem.stem_pool_3d_plain))
    return (*fns, torch.from_numpy(x_host).to(cuda), weight, scale, bias)


def _frames(kind, rng, draw):
    shape = (2, 120, 100, 3) if kind == "2d" else (2, 5, 60, 44)
    return draw(rng, shape).astype(np.float32)


@pytest.mark.parametrize("out", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_kernels_take_raw_frames(cuda, kind, out):
    """Frames of 0-255 integers, as uint8 frames arrive: sums ~100x those
    of normalized frames. f32 is held against the plain version in f64
    (the f32 conv's own rounding takes up to half the 1e-4 gate here);
    bf16 against the f32 plain version at 1e-2; the int8 stem with f32
    input, its step from the float output's max as ``calibrate`` takes
    it, against its plain version."""
    rng = np.random.default_rng(11)
    x = _frames(kind, rng, lambda r, s: r.integers(0, 256, s))
    kernel, plain, x, weight, scale, bias = _stem_inputs(kind, x, cuda, 12)
    if out == "int8":
        steps = (plain(x, weight, scale, bias).max() / 127.0).reshape(1)
        q_kernel, q_plain = ((stem.stem_pool_q_2d, stem.stem_pool_q_2d_plain)
                             if kind == "2d" else
                             (stem.stem_pool_q_3d, stem.stem_pool_q_3d_plain))
        got = q_kernel(x, weight, scale, bias, steps)
        _assert_int8_close(got, q_plain(x, weight, scale, bias, steps))
        return
    if out == "bf16":
        got = kernel(x.to(torch.bfloat16), weight, scale, bias)
        want = plain(x, weight, scale, bias)
    else:
        got = kernel(x, weight, scale, bias).double()
        want = plain(x.double(), weight.double(), scale.double(),
                     bias.double())
    tol = TOL[torch.float32 if out == "f32" else torch.bfloat16]
    torch.testing.assert_close(got.to(want.dtype), want, **tol)


@pytest.mark.parametrize("q", [False, True])
@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_kernels_take_a_zero_frame(cuda, kind, q):
    """An all-zero frame (a clip of zeros in 3D) beside a normal one: its
    tiles' max is 0 and must get a defined scale; the float output there
    is the pooled ReLU(bias)."""
    rng = np.random.default_rng(13)
    x = _frames(kind, rng, lambda r, s: r.standard_normal(s))
    x[0] = 0.0
    kernel, plain, x, weight, scale, bias = _stem_inputs(kind, x, cuda, 14)
    if q:
        steps = torch.tensor([0.02], device=cuda)
        q_kernel, q_plain = ((stem.stem_pool_q_2d, stem.stem_pool_q_2d_plain)
                             if kind == "2d" else
                             (stem.stem_pool_q_3d, stem.stem_pool_q_3d_plain))
        _assert_int8_close(q_kernel(x, weight, scale, bias, steps),
                           q_plain(x, weight, scale, bias, steps))
        return
    got = kernel(x, weight, scale, bias)
    torch.testing.assert_close(got, plain(x, weight, scale, bias),
                               **TOL[torch.float32])
    zero = got[:1] if kind == "2d" else got[:x.shape[1]]
    torch.testing.assert_close(zero, torch.relu(bias).expand_as(zero),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_kernel_takes_a_huge_input(cuda, kind):
    """One input of 1e6 among normal frames: the tile's scale follows it,
    so its other inputs keep absolute precision only (~2^-38 of 1e6). The
    output is finite and within 1e-4 of max |ref| of the plain version in
    f64; at this scale the f32 conv itself misses the absolute 1e-4."""
    rng = np.random.default_rng(15)
    x = _frames(kind, rng, lambda r, s: r.standard_normal(s))
    x.reshape(-1)[x.size // 3] = 1e6
    kernel, plain, x, weight, scale, bias = _stem_inputs(kind, x, cuda, 16)
    got = kernel(x, weight, scale, bias)
    assert bool(torch.isfinite(got).all())
    want = plain(x.double(), weight.double(), scale.double(), bias.double())
    assert float((got.double() - want).abs().max()) <= (
        1e-4 * float(want.abs().max()))


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
@pytest.mark.parametrize("shape", [(3, 224, 224), (2, 70, 90), (1, 9, 17),
                                   (2, 200, 168), (5, 112, 112),
                                   (2, 97, 131)])
def test_stem_pool_q_2d_kernel_matches_plain(cuda, dtype, n, shape):
    """f32 input takes the 3xFP16 body, bf16 the two-pass bf16 one;
    200 x 168 and 97 x 131 are no whole number of 7 x 7 pooled tiles."""
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
                                   (1, 1, 16, 16), (1, 2, 224, 224),
                                   (1, 3, 200, 168), (5, 4, 112, 112),
                                   (1, 7, 112, 112), (5, 7, 40, 52)])
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


FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 40, 64, 128])
@pytest.mark.parametrize("bh, n, s", [(2, 257, 130), (3, 65, 333),
                                      (1, 1, 1), (8, 2048, 2048)])
def test_flash_kernel_matches_plain(cuda, dtype, d, bh, n, s):
    rng = np.random.default_rng(d + n)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, m, d))
                                .astype(np.float32)).to(cuda).to(dtype)
               for m in (n, s, s))
    before = flash.flash_attention.launches
    out = flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = flash.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("d", [16, 32])
def test_flash_kernel_reads_the_heads_last_layout(cuda, d):
    """(B, N, H, D) views of one packed projection, as the port's MHA
    hands them over, read in place."""
    rng = np.random.default_rng(d)
    qkv = torch.from_numpy(rng.standard_normal((2, 300, 3, 8, d))
                           .astype(np.float32)).to(cuda)
    q, k, v = qkv.unbind(2)   # strided: row stride 3 * 8 * d
    out = flash.flash_attention(q, k, v)
    assert out.shape == (2, 300, 8, d) and out.is_contiguous()
    torch.testing.assert_close(out, flash.flash_attention_plain(q, k, v),
                               **FLASH_TOL[torch.float32])


def test_flash_route_on_the_card(cuda):
    """At 2048 queries and keys attention launches the kernel once; at
    2047 it takes the plain path; both agree."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 2048, 8, 16))
                         .astype(np.float32)).to(cuda)
    before = flash.flash_attention.launches
    routed = attention.dot_product_attention(x, x, x)
    assert flash.flash_attention.launches == before + 1
    attention.dot_product_attention(x[:, :2047], x, x)
    assert flash.flash_attention.launches == before + 1
    torch.testing.assert_close(routed, flash.flash_attention_plain(x, x, x),
                               **FLASH_TOL[torch.float32])


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 64, 16, device=cuda)
    with pytest.raises(TypeError):
        flash.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        empty = torch.zeros(2, 64, 0, device=cuda)
        flash.flash_attention(empty, empty, empty)
    with pytest.raises(ValueError):
        flash.flash_attention(q, q.cpu(), q)


def _flash_inputs(rng, layout, n, s, d, dtype, device):
    """q (.., n, .., d), k, v (.., s, .., d): contiguous (BH 3) or the
    heads-last views of packed tensors (2 heads), read in place."""
    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device).to(dtype)
    if layout == "bhnd":
        return draw((3, n, d)), draw((3, s, d)), draw((3, s, d))
    q = draw((1, n, 2, d + 3))[..., :d]      # row and head strides off 16 B
    k, v = draw((1, s, 2, 2, d)).unbind(2)   # row stride 4 d
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bhnd", "heads_last"])
@pytest.mark.parametrize("d", [1, 8, 16, 24, 32, 40, 64, 100, 128, 129, 256,
                               300])
@pytest.mark.parametrize("n, s", [(1, 2049), (17, 1), (2047, 17),
                                  (2049, 2047)])
def test_flash_kernel_tiles_match_plain(cuda, dtype, layout, d, n, s):
    """Every padded head-dim tile (D to the MMA k-step: 8 for f32, 16 for
    bf16), D past 128 in chunks of 128 (a last chunk of 1, 128 and 44
    dims), ragged query and key counts (a last key tile of 1 key, a
    single query row), both layouts; K and V rows on 16 bytes take
    cp.async, the others the staging through registers."""
    rng = np.random.default_rng(d * 7 + n + s)
    q, k, v = _flash_inputs(rng, layout, n, s, d, dtype, cuda)
    before = flash.flash_attention.launches
    out = flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = flash.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("d", [129, 256])
def test_attention_at_wide_head_dims_launches_the_kernel(cuda, d):
    """At 2048 queries and keys with D > 128 (the Pallas kernel pads any
    D) attention launches the kernel once and agrees with the plain
    version."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((1, 2048, 2, d))
                         .astype(np.float32)).to(cuda)
    before = flash.flash_attention.launches
    out = attention.dot_product_attention(x, x, x)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == before + 1
    assert out.shape == x.shape
    torch.testing.assert_close(out, flash.flash_attention_plain(x, x, x),
                               **FLASH_TOL[torch.float32])


def test_flash_refuses_attention_that_needs_grad(cuda):
    """The wrapper, and attention routed to it, raise on inputs that need
    grad (the kernel has no backward); under no_grad it launches."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((1, 2048, 2, 16))
                         .astype(np.float32)).to(cuda)
    w = q.clone().requires_grad_()
    before = flash.flash_attention.launches
    with pytest.raises(ValueError, match="no backward"):
        flash.flash_attention(q, w, q)
    with pytest.raises(ValueError, match="no backward"):
        attention.dot_product_attention(w, q, q)
    assert flash.flash_attention.launches == before
    with torch.no_grad():
        out = attention.dot_product_attention(w, q, q)
    assert flash.flash_attention.launches == before + 1
    torch.testing.assert_close(out, flash.flash_attention_plain(q, q, q),
                               **FLASH_TOL[torch.float32])


def test_train_step_on_card_matches_cpu(cuda):
    """One frozen Stage-II train step of a small flagship (D=64, 1 layer)
    with dropout off, on the card and on the CPU from the same weights:
    the stems go through the kernel (2 + 1 launches), the loss agrees to
    1e-4 relative and every gradient leaf at cosine >= 0.99999, and the
    frozen trunks stay bit for bit."""
    from egot2x_torch.core.config import Config
    from egot2x_torch.nn.common import Dropout
    from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader

    cfg = Config(model="TaskFusionMFTransformer3Task", weights=[0.266, 0.734],
                 lr=1e-3, wd=1e-2, hidden_dim=64, num_heads=4, num_layers=1,
                 dropout=0.0)
    tasks = [TalkingToMe2Loader(cfg, device=d) for d in (cuda, "cpu")]
    states = [t.build_state(0) for t in tasks]
    rng = np.random.default_rng(12)
    batch = dict(
        frames=rng.standard_normal((2, 4, 64, 64, 3)).astype(np.float32),
        video_asd=rng.uniform(0, 255, (2, 4, 112, 112)).astype(np.float32),
        audio=np.zeros((2, 4 * 16000 // 30), np.float32),
        audio_asd=rng.standard_normal((2, 16, 13)).astype(np.float32),
        label=np.array([0, 1]))
    out, grads = [], []
    frozen = {k: v.clone() for k, v in states[0].model.state_dict().items()
              if k.split(".", 1)[0] in ("lam_model", "ttm_model", "asd_model")}
    counts = stem.stem_pool_2d.launches, stem.stem_pool_3d.launches
    for task, state in zip(tasks, states):
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        device = next(state.model.parameters()).device
        _, metrics = task.train_step(
            state, {k: torch.from_numpy(v).to(device)
                    for k, v in batch.items()}, torch.Generator(device))
        out.append(float(metrics["loss"]))
        grads.append({n: p.grad.double().cpu()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None})
    assert (stem.stem_pool_2d.launches - counts[0],
            stem.stem_pool_3d.launches - counts[1]) == (2, 1)
    assert np.isfinite(out[0])
    assert abs(out[0] - out[1]) <= 1e-4 * abs(out[1])
    assert sorted(grads[0]) == sorted(grads[1])
    for name, g in grads[1].items():
        cos = float(grads[0][name].flatten() @ g.flatten()
                    / (grads[0][name].norm() * g.norm()))
        assert cos >= 0.99999, name
    after = states[0].model.state_dict()
    for k, v in frozen.items():
        assert torch.equal(after[k], v), k


# -- the float stem's training forward and backward ---------------------------

def _train_case(kind, shape, dtype, cuda, seed=21):
    """(x on the card in ``dtype``, weight, scale, bias) of a training
    stem, weights N(0, 1 / fan-in)."""
    rng = np.random.default_rng(seed)
    if kind == "2d":
        x = rng.standard_normal(shape + (3,)).astype(np.float32)
    else:
        x = rng.uniform(-2.5, 3.5, shape).astype(np.float32)
    _, _, x, weight, scale, bias = _stem_inputs(kind, x, cuda, seed + 1)
    return x.to(dtype), weight, scale, bias


def _conv_hw(kind, x):
    h, w = x.shape[1:3] if kind == "2d" else x.shape[2:4]
    return stem.conv_size(h), stem.conv_size(w)


def _train_forward(kind, x, weight, scale, bias):
    """The kernel's training forward, through ``_launch``, and its count."""
    w_taps, b, t, h, w = stem._float_geometry(2 if kind == "2d" else 3, x,
                                              weight)
    return stem._launch(2 if kind == "2d" else 3, x, w_taps, scale, bias, b,
                        t, h, w, train=True)


TRAIN_SHAPES = [("2d", (2, 224, 224)), ("2d", (3, 112, 112)),
                ("2d", (2, 200, 168)), ("2d", (2, 97, 131)),
                ("3d", (1, 7, 112, 112)), ("3d", (5, 7, 112, 112))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind, shape", TRAIN_SHAPES)
def test_stem_training_forward_matches_plain(cuda, kind, shape, dtype):
    """The training variant: its output is the inference kernel's bit for
    bit; its winners are ``F.max_pool2d``'s on the plain map in the
    output's type (bf16: rounded, where the kernel ties) in at least 99.9%
    of the windows, and every other one is a near-tie (the plain value
    at the kernel's winner within the output's tolerance of the window's
    max; ties are decided alike, first in row-major order); its saved
    conv values are the winners' (f32 rtol = atol = 1e-4; bf16: f32
    products of the bf16 frames and the weights as bf16 hi + lo, 1e-3)."""
    x, weight, scale, bias = _train_case(kind, shape, dtype, cuda)
    out, win, yw = _train_forward(kind, x, weight, scale, bias)
    infer = (stem.stem_pool_2d if kind == "2d" else stem.stem_pool_3d)(
        x, weight, scale, bias)
    torch.cuda.synchronize()
    assert torch.equal(out, infer)
    if kind == "2d":
        y = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), weight,
                                       stride=2, padding=3)
    else:
        y = stem._conv3d_frames(x.float(), weight)
    z = stem._affine_relu(y, scale, bias).to(dtype).float()
    ref, idx = torch.nn.functional.max_pool2d(z, 3, 2, 1, return_indices=True)
    torch.testing.assert_close(out.float(), ref.permute(0, 2, 3, 1),
                               **TOL[dtype])
    ho, wo = ref.shape[-2:]
    k = win.permute(0, 3, 1, 2).long()
    kernel_idx = ((2 * torch.arange(ho, device=cuda).view(ho, 1) - 1 + k // 3)
                  * y.shape[-1] + 2 * torch.arange(wo, device=cuda) - 1
                  + k % 3)
    same = kernel_idx == idx
    assert float(same.double().mean()) >= 0.999
    at_kernel = z.flatten(2).gather(2, kernel_idx.flatten(2)).view(ref.shape)
    tol = TOL[dtype]["rtol"]
    assert bool(((at_kernel - ref).abs() <= tol * (1 + ref.abs())).all())
    ref_yw = y.flatten(2).gather(2, idx.flatten(2)).view(ref.shape)
    same = same.permute(0, 2, 3, 1)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(yw[same], ref_yw.permute(0, 2, 3, 1)[same],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_training_winners_break_ties_first(cuda, kind):
    """A constant frame (clip) ties every interior window exactly: the
    kernel's winner there is the window's first position, as
    ``F.max_pool2d``'s is."""
    shape = (2, 64, 64) if kind == "2d" else (2, 3, 64, 64)
    x, weight, scale, bias = _train_case(kind, shape, torch.float32, cuda)
    x[0] = 0.5
    _, win, _ = _train_forward(kind, x, weight, scale, bias)
    assert bool((win[0, 2:-2, 2:-2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind, shape", TRAIN_SHAPES)
def test_stem_backward_kernel_matches_plain(cuda, kind, shape, dtype):
    """The backward kernel against its plain version on the same saved
    tensors (the training forward's): dy to 1e-5 relative (at most 4
    terms a position, summed in another order); dscale and dbias to 1e-5
    of the sum of their terms' magnitudes (the blocks' partial sums in
    another order than the plain version's); one launch."""
    x, weight, scale, bias = _train_case(kind, shape, dtype, cuda)
    out, win, yw = _train_forward(kind, x, weight, scale, bias)
    rng = np.random.default_rng(23)
    dp = torch.from_numpy(rng.standard_normal(tuple(out.shape))
                          .astype(np.float32)).to(cuda).to(dtype)
    hw = _conv_hw(kind, x)
    before = stem.stem_pool_backward.launches
    dy, dscale, dbias = stem.stem_pool_backward(dp, out, win, yw, scale, hw)
    torch.cuda.synchronize()
    assert stem.stem_pool_backward.launches == before + 1
    want = stem.stem_pool_backward_plain(dp, out, win, yw, scale, hw)
    assert dy.shape == want[0].shape and dy.dtype == torch.float32
    torch.testing.assert_close(dy, want[0], rtol=1e-5,
                               atol=1e-6 * float(want[0].abs().max()))
    g = torch.where(out > 0, dp.float(), 0.0)
    for got, ref, terms in ((dscale, want[1], (g * yw).abs()),
                            (dbias, want[2], g.abs())):
        bound = 1e-5 * terms.sum((0, 1, 2)) + 1e-30
        assert bool(((got - ref).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_function_gradients_match_plain(cuda, kind, dtype):
    """The differentiable stem on the card (training kernel, backward
    kernel, the library's conv gradients; one launch of each kernel):
    dscale and dbias against autograd of the plain version (cuDNN, TF32
    off; bf16: in f32 on the bf16 frames), per channel to 1e-5 (bf16:
    1e-3) of the sum of their terms' magnitudes (random dp cancels in the
    sums; a winner that flips at a near-tie moves its term to a near-equal
    value, a ReLU input at the kink one term in or out); dW and dx, which
    such a flip moves to another input patch, against the library's conv
    gradients of the plain backward routed by the same winners, 1e-5 (bf16:
    1e-3, as dx is rounded to bf16)."""
    shape = (4, 96, 80) if kind == "2d" else (2, 5, 64, 48)
    x, weight, scale, bias = _train_case(kind, shape, dtype, cuda)
    fn, plain = ((stem.stem_pool_2d, stem.stem_pool_2d_plain) if kind == "2d"
                 else (stem.stem_pool_3d, stem.stem_pool_3d_plain))
    ours = [v.clone().requires_grad_() for v in (x, weight, scale, bias)]
    counts = (stem.stem_pool_2d.launches + stem.stem_pool_3d.launches,
              stem.stem_pool_backward.launches)
    out = fn(*ours)
    rng = np.random.default_rng(24)
    dp = torch.from_numpy(rng.standard_normal(tuple(out.shape))
                          .astype(np.float32)).to(cuda).to(dtype)
    got = torch.autograd.grad(out, ours, dp)
    torch.cuda.synchronize()
    assert (stem.stem_pool_2d.launches + stem.stem_pool_3d.launches,
            stem.stem_pool_backward.launches) == (counts[0] + 1,
                                                  counts[1] + 1)
    for name, g in zip(("x", "weight", "scale", "bias"), got):
        assert g.dtype == (dtype if name == "x" else torch.float32), name
    ref_in = [v.float().clone().requires_grad_()
              for v in (x, weight, scale, bias)]
    want = torch.autograd.grad(plain(*ref_in), ref_in, dp.float())
    code = 2 if kind == "2d" else 3
    saved = _train_forward(kind, x, weight, scale, bias)
    g = torch.where(saved[0] > 0, dp.float(), 0.0)
    bar = 1e-5 if dtype == torch.float32 else 1e-3
    for ours, ref, terms in ((got[2], want[2], g * saved[2]),
                             (got[3], want[3], g)):
        bound = bar * terms.abs().sum((0, 1, 2))
        assert bool(((ours - ref).abs() <= bound).all())
    dy = stem.stem_pool_backward_plain(dp, *saved, scale,
                                       _conv_hw(kind, x))[0]
    dx, dw = stem._conv_grads(code, x, weight, dy, True, True)
    for g, w in ((got[0], dx), (got[1], dw)):
        assert float((g.float() - w.float()).norm() / w.float().norm()) <= (
            1e-5 if dtype == torch.float32 else 1e-3)


def test_int8_stems_refuse_inputs_that_need_grad(cuda):
    """The int8 stems have no backward: inputs that need grad raise before
    any launch; under no_grad they launch."""
    rng = np.random.default_rng(25)
    weight, scale, bias = _params(rng, (64, 3, 7, 7), cuda)
    x = torch.zeros(1, 32, 32, 3, device=cuda)
    steps = torch.tensor([0.02], device=cuda)
    w = weight.clone().requires_grad_()
    before = stem.stem_pool_q_2d.launches
    with pytest.raises(ValueError, match="no backward"):
        stem.stem_pool_q_2d(x, w, scale, bias, steps)
    w3 = torch.zeros(64, 1, 5, 7, 7, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        stem.stem_pool_q_3d(torch.zeros(1, 5, 32, 32, device=cuda), w3,
                            scale, bias, steps)
    assert stem.stem_pool_q_2d.launches == before
    with torch.no_grad():
        stem.stem_pool_q_2d(x, w, scale, bias, steps)
    assert stem.stem_pool_q_2d.launches == before + 1


def _leaf_gaps(card, cpu):
    """(largest relative norm gap, least cosine) over the gradient
    leaves; leaves whose CPU norm is below 1e-6 per element's root (the
    attention key biases, whose gradient is 0 in exact arithmetic) count
    by absolute gap only."""
    worst_rel, worst_cos = 0.0, 1.0
    for name, g in cpu.items():
        c = card[name]
        floor = 1e-6 * np.sqrt(g.numel())
        gap = float((c - g).norm())
        if float(g.norm()) <= floor:
            assert gap <= floor, name
            continue
        worst_rel = max(worst_rel, gap / float(g.norm()))
        worst_cos = min(worst_cos, float(c.flatten() @ g.flatten()
                                         / (c.norm() * g.norm())))
    return worst_rel, worst_cos


@pytest.mark.parametrize("remat", [False, True], ids=["nofreeze", "remat"])
def test_trainable_trunk_step_on_card_matches_cpu(cuda, remat):
    """One ``nofreeze`` Stage-II train step of a small flagship (D=64, 1
    layer) with dropout off, with and without ``remat``, on the card and
    on the CPU from the same weights: per step 2 + 1 stem launches
    forward (twice that under remat) and 3 backward launches; the loss
    agrees to 1e-4 relative; every gradient leaf, the trunks' included,
    within 5e-2 of its norm and at cosine >= 0.999 (the kernel and cuDNN
    round the stem's conv apart, so a few pool windows whose two largest
    values nearly tie pick another winner on each device, and a ReLU
    input within f32 rounding of 0 may land on the other side of the
    kink: each moves one term of a leaf's sum; a gradient routed wrong
    is off by O(1)); the trunks' BN statistics stay bit for bit."""
    from egot2x_torch.core.config import Config
    from egot2x_torch.nn.common import Dropout
    from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader

    cfg = Config(model="TaskFusionMFTransformer3Task", weights=[0.266, 0.734],
                 lr=1e-3, wd=1e-2, hidden_dim=64, num_heads=4, num_layers=1,
                 dropout=0.0, nofreeze=True, remat=remat)
    tasks = [TalkingToMe2Loader(cfg, device=d) for d in (cuda, "cpu")]
    states = [t.build_state(0) for t in tasks]
    rng = np.random.default_rng(26)
    batch = dict(
        frames=rng.standard_normal((2, 4, 64, 64, 3)).astype(np.float32),
        video_asd=rng.uniform(0, 255, (2, 4, 112, 112)).astype(np.float32),
        audio=np.zeros((2, 4 * 16000 // 30), np.float32),
        audio_asd=rng.standard_normal((2, 16, 13)).astype(np.float32),
        label=np.array([0, 1]))
    stats = {k: v.clone() for k, v in states[0].model.named_buffers()
             if k.split(".", 1)[0] in ("lam_model", "ttm_model", "asd_model")}
    counters = (stem.stem_pool_2d, stem.stem_pool_3d, stem.stem_pool_backward)
    before = [c.launches for c in counters]
    out, grads = [], []
    for task, state in zip(tasks, states):
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        device = next(state.model.parameters()).device
        _, metrics = task.train_step(
            state, {k: torch.from_numpy(v).to(device)
                    for k, v in batch.items()}, torch.Generator(device))
        out.append(float(metrics["loss"]))
        grads.append({n: p.grad.double().cpu()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None})
    fwd = 2 if remat else 1
    assert [c.launches - b for c, b in zip(counters, before)] == [
        2 * fwd, fwd, 3]
    assert np.isfinite(out[0])
    assert abs(out[0] - out[1]) <= 1e-4 * abs(out[1])
    assert sorted(grads[0]) == sorted(grads[1])
    assert len(grads[0]) == len(list(states[0].model.parameters()))
    rel, cos = _leaf_gaps(grads[0], grads[1])
    assert rel <= 5e-2 and cos >= 0.999, (rel, cos)
    after = dict(states[0].model.named_buffers())
    for k, v in stats.items():
        assert torch.equal(after[k], v), k


def test_training_mode_stems_launch_no_kernel(cuda):
    """A ResNet-18 and TalkNet in training mode (Stage I) run their stems
    with batch statistics, as library ops: no stem kernel launch; in eval
    mode each launches its kernel once."""
    from egot2x_torch.nn.common import set_dropout_generator
    from egot2x_torch.nn.resnet2d import ResNet2D
    from egot2x_torch.nn.talknet import TalkNetModel

    frames = torch.randn(4, 64, 64, 3, device=cuda)
    faces = torch.rand(2, 4, 64, 64, device=cuda) * 255
    mfcc = torch.randn(2, 16, 13, device=cuda)
    resnet = ResNet2D().to(cuda)
    talknet = set_dropout_generator(TalkNetModel().to(cuda),
                                    torch.Generator(cuda))
    for mode, launches in ((True, 0), (False, 1)):
        before = (stem.stem_pool_2d.launches, stem.stem_pool_3d.launches)
        with torch.no_grad():
            resnet.train(mode)(frames)
            talknet.train(mode)(mfcc, faces)
        torch.cuda.synchronize()
        assert (stem.stem_pool_2d.launches - before[0],
                stem.stem_pool_3d.launches - before[1]) == (launches,
                                                            launches), mode


def _stage1_batch(name, rng):
    if name == "BaselineLSTM":
        return dict(frames=rng.standard_normal((2, 7, 64, 64, 3)).astype(
            np.float32), label=np.array([0, 1]))
    if name == "TTMBaselineLSTM":
        return dict(frames=rng.standard_normal((2, 15, 64, 64, 3)).astype(
            np.float32), audio=(rng.standard_normal((2, 8000)) * 0.1).astype(
                np.float32), label=np.array([1, 0]))
    return dict(mfcc=rng.standard_normal((2, 60, 13)).astype(np.float32),
                faces=rng.uniform(0, 255, (2, 15, 112, 112)).astype(
                    np.float32), labels=rng.integers(0, 2, (2, 15)))


@pytest.mark.parametrize("name", ["BaselineLSTM", "TTMBaselineLSTM",
                                  "TalkNetWithHeads"])
def test_stage1_step_on_card_matches_cpu(cuda, name):
    """One Stage-I train step of each task (dropout off) on the card in f32
    and on the CPU in f64 from the same weights: no stem kernel launch; the
    loss to 1e-4 relative; every BN running statistic to 1e-4 of its
    layer's largest; every gradient leaf within 5e-2 of its norm and at
    cosine >= 0.999 (a ReLU input or a pool window within f32 rounding of
    a tie moves the leaves below it through the batch-statistics BNs'
    backward: an f32 CPU step lands up to ~1e-2 off the f64 one itself; a
    gradient routed wrong is off by O(1))."""
    from egot2x_torch.core.config import Config
    from egot2x_torch.nn.common import Dropout
    from egot2x_torch.tasks.asd import ActiveSpeakerDetection
    from egot2x_torch.tasks.lam import LookingAtMe
    from egot2x_torch.tasks.ttm import TalkingToMe

    cls, cfg = {
        "BaselineLSTM": (LookingAtMe, dict(weights=[0.136, 0.864])),
        "TTMBaselineLSTM": (TalkingToMe, dict(weights=[0.266, 0.734],
                                              wd=1e-4)),
        "TalkNetWithHeads": (ActiveSpeakerDetection, dict(lr_decay=0.95)),
    }[name]
    cfg = Config(model=name, lr=1e-3, **cfg)
    batch = _stage1_batch(name, np.random.default_rng(27))
    counters = (stem.stem_pool_2d, stem.stem_pool_3d)
    before = [c.launches for c in counters]
    losses, grads, stats = [], [], []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        task = cls(cfg, device=device)
        state = task.build_state(0)
        state.model.to(dtype)
        for m in state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        inputs = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        _, metrics = task.train_step(
            state, {k: v.to(dtype) if v.is_floating_point() else v
                    for k, v in inputs.items()}, torch.Generator(device))
        losses.append(float(metrics["loss"]))
        grads.append({n: p.grad.double().cpu()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None})
        stats.append({k: v.cpu() for k, v in state.model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))})
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0]
    assert np.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for k, v in stats[1].items():
        assert float((stats[0][k].double() - v).abs().max()) <= 1e-4 * float(
            v.abs().max()), k
    assert sorted(grads[0]) == sorted(grads[1])
    rel, cos = _leaf_gaps(grads[0], grads[1])
    assert rel <= 5e-2 and cos >= 0.999, (rel, cos)


def test_masked_and_causal_attention_never_launch_flash(cuda):
    """At 2048 queries and keys, attention with a mask or causal takes the
    plain path on the card (no launch), as in the JAX package, and agrees
    with the CPU; a fully masked row comes out as zeros."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((1, 2048, 4, 16))
                         .astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(1, 1, 2048, 2048)) > 0.2)
    mask[..., 0] = True
    mask[0, 0, 5] = False
    before = flash.flash_attention.launches
    for kw in (dict(mask=mask), dict(is_causal=True),
               dict(mask=mask, is_causal=True)):
        got = attention.dot_product_attention(
            *(v.to(cuda) for v in (x, x, x)),
            **{k: v.to(cuda) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()})
        torch.cuda.synchronize()
        want = attention.dot_product_attention(x, x, x, **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
        if "mask" in kw:
            assert not got[0, 5].any()
    assert flash.flash_attention.launches == before


def test_prompt_encoder_at_2100_tokens_launches_flash(cuda):
    """The EgoT2-g prompt encoder at run_multitask's widths (D 256, 4 heads,
    3 layers) on the 3 x 700 tokens of one ASD track launches the kernel
    once a layer, at (4, 2100, 64), and agrees with the CPU's plain
    attention."""
    from egot2x_torch.core import bridge
    from egot2x_torch.nn.common import TransformerEncoder

    cpu = TransformerEncoder(3, 256, 4).eval()
    bridge.load_jax_variables(cpu, bridge.random_jax_variables(cpu, seed=4))
    gpu = TransformerEncoder(3, 256, 4).to(cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((1, 2100, 256))
                         .astype(np.float32))
    before = flash.flash_attention.launches
    with torch.no_grad():
        got = gpu(x.to(cuda))
        torch.cuda.synchronize()
        want = cpu(x)
    assert flash.flash_attention.launches == before + 3
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def test_decoder_on_card_matches_cpu(cuda):
    """The causal post-LN decoder (D 256, 4 heads, 3 layers) on 2 target
    tokens over the 45 memory tokens of a 15-frame request, with the
    cross-attention weights, on the card and on the CPU: no flash launch,
    rtol = atol = 1e-4."""
    from egot2x_torch.core import bridge
    from egot2x_torch.nn.common import TransformerDecoder

    cpu = TransformerDecoder(3, 256, 4).eval()
    bridge.load_jax_variables(cpu, bridge.random_jax_variables(cpu, seed=5))
    gpu = TransformerDecoder(3, 256, 4).to(cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(23)
    tgt, memory = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32))
                   for shape in ((30, 2, 256), (30, 45, 256)))
    before = flash.flash_attention.launches
    with torch.no_grad():
        got, got_w = gpu(tgt.to(cuda), memory.to(cuda), return_weights=True)
        want, want_w = cpu(tgt, memory, return_weights=True)
    assert flash.flash_attention.launches == before
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_w.cpu(), want_w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_pool_2d_kernel_at_the_pnr_crop(cuda, dtype):
    """The 2D stem at the PNR crop, 225^2 raw 0-255 frames (as
    ``KeyframeCnnLSTM`` is fed): odd conv (113^2) and pooled (57^2) edges,
    whose last tile is partial. f32 against the plain version in f64 and
    bf16 against it in f32, as ``test_stem_kernels_take_raw_frames``
    holds raw frames; f32 also within 2^-20 of each output's sum of term
    magnitudes (the f32 conv's rounding grows with it: on raw frames the
    sums reach ~1,200 a window, and cuDNN's own f32 conv misses the bare
    1e-4 at 256 such frames; chip_smoke.py's hoi phase prints both)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(0, 256, (4, 225, 225, 3)).astype(
        np.float32)).to(cuda).to(dtype)
    weight, scale, bias = _params(rng, (64, 3, 7, 7), cuda)
    weight = weight * (10.0 / np.sqrt(147))
    before = stem.stem_pool_2d.launches
    out = stem.stem_pool_2d(x, weight, scale, bias)
    torch.cuda.synchronize()
    assert stem.stem_pool_2d.launches == before + 1
    assert out.shape == (4, 57, 57, 64)
    if dtype == torch.bfloat16:
        ref = stem.stem_pool_2d_plain(x.float(), weight, scale, bias)
        torch.testing.assert_close(out.float(), ref, **TOL[dtype])
        return
    ref = stem.stem_pool_2d_plain(x.double(), weight.double(),
                                  scale.double(), bias.double())
    terms = torch.nn.functional.conv2d(
        x.double().abs().permute(0, 3, 1, 2), weight.double().abs(),
        stride=2, padding=3) * scale.double().abs()[:, None, None]
    terms = torch.nn.functional.max_pool2d(terms, 3, 2, 1).permute(0, 2, 3, 1)
    err = (out.double() - ref).abs()
    assert bool((err <= 1e-4 + 1e-4 * ref.abs() + 2.0 ** -20 * terms).all())


def _seeded_on_both(name, cuda, calibration, **kwargs):
    """``name`` on the card and on the CPU with the bridge's seeded weights
    and, where the model takes raw pixels, the statistics of its stem's BN
    (and of its dot_product Nonlocals' BNs) from ``calibration`` by precise
    BN on the CPU (tests/test_torch_port_resnet3d.py says why)."""
    from egot2x_torch.core import bridge
    from egot2x_torch.core.registry import build_model
    from egot2x_torch.nn.resnet3d import Nonlocal
    from egot2x_torch.train.precise_bn import compute_precise_bn_stats

    cpu = build_model(name, device="cpu", **kwargs)
    bridge.load_jax_variables(cpu, bridge.random_jax_variables(cpu, 5))
    if calibration is not None:
        stem_bn = (cpu.backbone.bn1 if hasattr(cpu, "backbone")
                   else cpu.trunk.s1.bn)
        bns = [stem_bn] + [m.bn for m in cpu.modules()
                           if isinstance(m, Nonlocal)
                           and m.instantiation == "dot_product"]
        compute_precise_bn_stats(cpu, [(calibration,)], 1, bns=bns)
    card = build_model(name, device=cuda, **kwargs)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def test_cnn_lstm_stem_at_225_on_card_matches_cpu(cuda):
    """``KeyframeCnnLSTM`` on 2 clips x 4 frames of 225^2 raw pixels: one
    stem kernel launch covers the 8 frames; the stem's output and the
    scores against the CPU (plain stem), 1e-4 relative to the map's and
    1e-3 (1 + |score|)."""
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (3, 2, 4, 225, 225, 3)).astype(np.float32)
    card, cpu = _seeded_on_both("KeyframeCnnLSTM", cuda,
                                torch.from_numpy(frames[2]))
    x = torch.from_numpy(frames[0])
    stems = {}
    for name, model in (("card", card), ("cpu", cpu)):
        model.backbone.layer1.register_forward_pre_hook(
            lambda m, a, name=name: stems.__setitem__(name, a[0]))
    before = stem.stem_pool_2d.launches
    with torch.no_grad():
        got = card(x.to(cuda))
        want = cpu(x)
    torch.cuda.synchronize()
    assert stem.stem_pool_2d.launches == before + 1
    assert stems["card"].shape == (8, 64, 57, 57)
    err = (stems["card"].cpu() - stems["cpu"]).abs().max()
    assert err <= 1e-4 * stems["cpu"].abs().max()
    assert got.shape == (2, 4)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["KeyframeLocalizationResNet",
                                  "StateChangeClsResNet", "DualHeadResNet"])
def test_pnr_model_on_card_matches_cpu(cuda, name):
    """The ResNet3D-50 PNR models at crop 65 (2 clips x 4 frames, raw
    uint8; the keyframe model with two dot_product Nonlocals) on the card
    (channels_last_3d) against the CPU: 1e-3 (1 + |logit|); the uint8 and
    the f32 [0, 255] feed agree on the card; no stem kernel launch (the
    video stem is the library's)."""
    from egot2x_torch.nn.resnet3d import resolve_nonlocal

    kwargs = dict(crop_size=65)
    if name == "KeyframeLocalizationResNet":
        kwargs["nonlocal_cfg"] = resolve_nonlocal([[[]], [[1]], [[1]], [[]]])
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (2, 2, 4, 65, 65, 3)).astype(np.uint8)
    card, cpu = _seeded_on_both(name, cuda, torch.from_numpy(frames[1]),
                                **kwargs)
    x = torch.from_numpy(frames[0])
    before = (stem.stem_pool_2d.launches, stem.stem_pool_3d.launches)
    with torch.no_grad():
        got, got_f32, want = (card(x.to(cuda)), card(x.to(cuda).float()),
                              cpu(x))
    torch.cuda.synchronize()
    assert (stem.stem_pool_2d.launches, stem.stem_pool_3d.launches) == before
    for g, f, w in zip(*(v if isinstance(v, tuple) else (v,)
                         for v in (got, got_f32, want))):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(f, g, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name, launches", [
    ("FinetuneTTM", (1, 0)), ("LAM2TTM", (1, 0)), ("ASD2TTM", (0, 1)),
    ("TaskFusionLFLinear3Task", (2, 1))])
def test_ttm_baseline_on_card_matches_cpu(cuda, name, launches):
    """Each TTM baseline on 2 clips x 8 frames (RGB 64^2 uint8, faces 48^2,
    MFCC): its stem launches a forward, and the logits against the CPU,
    1e-3 (1 + |logit|)."""
    rng = np.random.default_rng(10)
    inputs = (torch.from_numpy(rng.integers(0, 256, (2, 8, 64, 64, 3)).astype(
                  np.uint8)),
              torch.from_numpy(rng.uniform(0, 255, (2, 8, 48, 48)).astype(
                  np.float32)),
              torch.zeros(2, 8 * 16000 // 30),
              torch.from_numpy(rng.standard_normal((2, 32, 13)).astype(
                  np.float32)))
    card, cpu = _seeded_on_both(name, cuda, None)
    before = (stem.stem_pool_2d.launches, stem.stem_pool_3d.launches)
    with torch.no_grad():
        got = card(*(v.to(cuda) for v in inputs))
        want = cpu(*inputs)
    torch.cuda.synchronize()
    assert (stem.stem_pool_2d.launches - before[0],
            stem.stem_pool_3d.launches - before[1]) == launches
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape, o, kernel, stride, pad", [
    ((2, 64, 16, 57, 57), 64, (1, 3, 3), (1, 1, 1), (0, 1, 1)),  # res2 b
    ((2, 1024, 16, 15, 15), 256, (3, 1, 1), (1, 1, 1), (1, 0, 0)),  # res4 a
    ((2, 256, 4, 29, 29), 512, (1, 1, 1), (1, 2, 2), (0, 0, 0)),  # branch1
    ((2, 8, 32, 56, 56), 8, (3, 1, 1), (1, 1, 1), (1, 0, 0)),  # fast a
    ((2, 12, 4, 9, 9), 20, (1, 3, 3), (1, 2, 2), (0, 1, 1)),  # off 8
])
def test_int8_conv3d_matches_plain_bit_for_bit(cuda, shape, o, kernel,
                                               stride, pad):
    rng = np.random.default_rng(shape[1] + o)
    x = torch.from_numpy(rng.integers(-127, 128, shape,
                                      dtype=np.int8)).to(cuda)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    w = torch.from_numpy(rng.integers(-127, 128, (o, shape[1], *kernel),
                                      dtype=np.int8)).to(cuda)
    before = int8.conv3d_int8.launches
    got = int8.conv3d_int8(x, w, stride, pad)
    assert int8.conv3d_int8.launches == before + 1
    want = int8.conv3d_int8_plain(x, w, stride, pad)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_ts_pnr_on_card_matches_cpu(cuda, dtype):
    """ts_pnr with int8 trunks (D 64, 1 layer; 2 clips of 4 raw uint8
    frames at crop 65, pathways 2 + 8 frames of 64^2, alpha 4), seeded,
    its stems' BNs fitted, calibrated on the card: one ``int8_conv3d``
    launch a ``QuantConv3d`` a forward, none of any other kernel; logits
    against the CPU's (the same scales; the plain f64 conv) at cosine >
    0.999, the 2D int8 slice's bar (a value at a quantization boundary
    can land a quantum apart on the two devices)."""
    from egot2x_torch.core import bridge
    from egot2x_torch.core.registry import build_model
    from egot2x_torch.nn.quant import QuantConv3d, calibrate
    from egot2x_torch.train.precise_bn import compute_precise_bn_stats

    kw = dict(target="keyframe", feature_dim=64, num_layers=1, crop_size=65,
              alpha=4, pnr_frames=4, action_frames=8, quant=True,
              dtype=getattr(torch, dtype))
    rng = np.random.default_rng(4)
    frames, cal = (torch.from_numpy(rng.integers(
        0, 256, (2, 4, 65, 65, 3)).astype(np.uint8)) for _ in range(2))
    paths = [torch.from_numpy(rng.integers(0, 256, (2, t, 64, 64, 3)).astype(
        np.uint8)) for t in (2, 8)]
    cpu = build_model("TaskFusionMFTransformer3TaskDropout", device="cpu",
                      **kw)
    bridge.load_jax_variables(cpu, bridge.random_jax_variables(cpu, 5))
    for trunk in (cpu.pnr_model.trunk, cpu.oscc_model.trunk):
        compute_precise_bn_stats(trunk.s1, [(cal,)], 1, bns=[trunk.s1.bn])
    card = build_model("TaskFusionMFTransformer3TaskDropout", device=cuda,
                       **kw)
    card.load_state_dict(cpu.state_dict())
    feed = (frames.to(cuda), [p.to(cuda) for p in paths])
    calibrate(card, *feed)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    convs = sum(isinstance(m, QuantConv3d) for m in card.modules())
    before = {k: f.launches for k, f in (
        ("conv3d", int8.conv3d_int8), ("conv2d", int8.conv2d_int8),
        ("stem2d", stem.stem_pool_2d), ("stem3d", stem.stem_pool_3d),
        ("flash", flash.flash_attention))}
    with torch.no_grad():
        got = card(*feed).float().cpu()
        want = cpu(frames, paths).float()
    after = {k: f.launches for k, f in (
        ("conv3d", int8.conv3d_int8), ("conv2d", int8.conv2d_int8),
        ("stem2d", stem.stem_pool_2d), ("stem3d", stem.stem_pool_3d),
        ("flash", flash.flash_attention))}
    assert convs == 208
    assert {k: after[k] - before[k] for k in after} == dict(
        conv3d=convs, conv2d=0, stem2d=0, stem3d=0, flash=0)
    assert got.shape == (2, 16) and torch.isfinite(got).all()
    g, w = got.double().flatten(), want.double().flatten()
    assert float(g @ w / (g.norm() * w.norm())) > 0.999
