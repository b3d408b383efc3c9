"""Card tests: the hand-written CUDA stem and flash-attention kernels
against their plain versions, the int8 conv's ``torch._int_mm`` route
against its exact plain version, the attention route on the card, and
small flagships (float and int8) on the card against the CPU.

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
rounding of a half-integer flips). int8 conv: bit for bit. Flash kernel vs
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
        big = torch.zeros(2, 64, 160, device=cuda)
        flash.flash_attention(big, big, big)
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
@pytest.mark.parametrize("d", [1, 8, 16, 24, 32, 40, 64, 100, 128])
@pytest.mark.parametrize("n, s", [(1, 2049), (17, 1), (2047, 17),
                                  (2049, 2047)])
def test_flash_kernel_tiles_match_plain(cuda, dtype, layout, d, n, s):
    """Every padded head-dim tile (D to the MMA k-step: 8 for f32, 16 for
    bf16), ragged query and key counts (a last key tile of 1 key, a
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
