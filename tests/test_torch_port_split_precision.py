"""The tensor-core kernels' arithmetic, emulated with torch on the CPU and
held against the JAX package.

The CUDA kernels cannot run here, so each test repeats what a kernel
computes wherever the numbers depend on it, and holds that against the
JAX package's kernels:

* ``csrc/flash_attention.cu``, f32 input: both products as 3xTF32, x = hi
  + lo with hi = x rounded to TF32 by a Veltkamp split (c = x * 8193, hi =
  c - (c - x), in f32) and lo = x - hi truncated to TF32 (the low 13
  mantissa bits dropped), a b ~ hi bh + hi bl + lo bh summed in f32; P
  split the same way before P V. Key tiles of 64 (32 at D > 64), the
  running max on unscaled scores starting at -1e30, p = exp2(s c - m c)
  with c = log2(e) / sqrt(D), keys past S at -1e30, acc / max(l, 1e-30).
  Against ``egot2x.ops.pallas_attention.flash_attention`` in interpret
  mode at the shapes of tests/test_pallas_attention.py with the small
  head dims, rtol 1e-4, atol 1e-5: the f32 gate. One TF32 pass misses it.
* the same kernel, bf16 input: exact bf16 products in f32, P rounded to
  bf16 for P V, the sum l over the f32 P, the output rounded to bf16;
  rtol = atol = 1e-2, the bf16 gate.
* ``csrc/stem_pool.cu``'s tensor-core int8 stem (bf16 input): the conv of
  the exact bf16 frames with w_hi and with w_lo (``ops.stem.split_bf16``)
  summed in f32, then the plain version's BN, ReLU, quantize and int8
  pool. Against ``fused_stem_pool_q`` in interpret mode and the XLA int8
  stems (2D with 1 and 2 trunks, 3D): |diff| <= 1 quantum, >= 99.9% equal,
  the bar of tests/test_torch_port_stem_q.py. Its epilogue's quantizer
  (the quotient y / s from r = 1 / s and one FMA correction, rounded by
  the 1.5 * 2^23 addition) gives the plain version's min(rint(y / s),
  127) exactly.

The JAX side of each comparison is computed once per module.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from egot2x.nn.fused_stem import fused_rgb_stem  # noqa: E402
from egot2x.nn.quant import quantize_static as jax_quantize  # noqa: E402
from egot2x.nn.talknet import _packed_phase_pool, _Stem3DConv  # noqa: E402
from egot2x.ops.pallas_attention import flash_attention as jax_flash  # noqa: E402
from egot2x.ops.pallas_stem import (  # noqa: E402
    flatten_packed_kernel, fold_bn, fold_bn_quant, fused_stem_pool,
    fused_stem_pool_q, pack_stem_kernel, pack_stem_kernel_3d, s2d_input,
    s2d_input_3d)
from egot2x_torch.ops import stem  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

FLASH_SHAPES = [(257, 130, 40), (96, 160, 16), (160, 96, 32)]  # N, S, D
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
NEG = -1e30
SHARE_EQUAL = 0.999


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_exact(a):
    """``a`` rounded to bf16 and back to f32: what a bf16 tensor holds."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# -- flash attention ---------------------------------------------------


def split_tf32(x):
    """The kernel's split of f32 ``x``: hi = x rounded to 11 significant
    bits (Veltkamp), lo = x - hi (exact) truncated to TF32."""
    c = x * 8193.0
    hi = c - (c - x)
    lo = ((x - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def _mm_3xtf32(a, b):
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return ah @ bl + al @ bh + ah @ bh


def _mm_1xtf32(a, b):
    return split_tf32(a)[0] @ split_tf32(b)[0]


def _mm_bf16(a, b):
    return a @ b


def emulated_flash(q, k, v, mm=_mm_3xtf32, p_bf16=False):
    """The kernel's online softmax over (BH, N, D) f32 tensors, with the
    products of ``mm``; ``p_bf16`` rounds P to bf16 before P V."""
    n, s, d = q.shape[1], k.shape[1], q.shape[2]
    block = 64 if d <= 64 else 32
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full(q.shape[:2], NEG)
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros(q.shape)
    for k0 in range(0, s, block):
        kt, vt = k[:, k0:k0 + block], v[:, k0:k0 + block]
        sc = mm(q, kt.transpose(1, 2))
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2((m - mx) * c)
        p = torch.exp2(sc * c - (mx * c)[..., None])
        l = l * alpha + p.sum(-1)
        pv = p.to(torch.bfloat16).float() if p_bf16 else p
        acc = acc * alpha[..., None] + mm(pv, vt)
        m = mx
    return acc / torch.clamp(l, min=1e-30)[..., None]


@pytest.fixture(scope="module")
def flash_cases():
    """{(N, S, D): (q, k, v, JAX output)} at f32 and at bf16-exact inputs."""
    cases = {}
    for n, s, d in FLASH_SHAPES:
        rng = np.random.default_rng(n + s + d)
        qkv = [rng.standard_normal((2, m, d)).astype(np.float32)
               for m in (n, s, s)]
        for name, arrays in (("f32", qkv), ("bf16", [_bf16_exact(a)
                                                     for a in qkv])):
            want = np.asarray(jax_flash(*map(jnp.asarray, arrays),
                                        block_q=128, block_k=128,
                                        interpret=True))
            cases[name, n, s, d] = (*map(_t, arrays), want)
    return cases


def test_veltkamp_split_rounds_to_nearest_tf32():
    """hi is x rounded to nearest with 10 mantissa bits (equal to round
    half to even but at exact ties), hi + lo holds x to 2^-21."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000)
                         .astype(np.float32) * 10.0)
    hi, lo = split_tf32(x)
    bits = x.view(torch.int32)
    rne = ((bits + 0xFFF + ((bits >> 13) & 1)) & -8192).view(torch.float32)
    ties = (bits & 0x1FFF) == 0x1000
    assert torch.equal(hi[~ties], rne[~ties])
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi.double() + lo.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("n, s, d", FLASH_SHAPES)
def test_flash_3xtf32_holds_the_f32_gate(flash_cases, n, s, d):
    q, k, v, want = flash_cases["f32", n, s, d]
    np.testing.assert_allclose(emulated_flash(q, k, v).numpy(), want,
                               **F32_TOL)


@pytest.mark.parametrize("n, s, d", FLASH_SHAPES)
def test_flash_one_tf32_pass_misses_the_f32_gate(flash_cases, n, s, d):
    """Why three passes: one TF32 product (~5e-4 relative) breaks rtol
    1e-4, atol 1e-5 somewhere."""
    q, k, v, want = flash_cases["f32", n, s, d]
    got = emulated_flash(q, k, v, mm=_mm_1xtf32).numpy()
    assert not np.allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("n, s, d", FLASH_SHAPES)
def test_flash_bf16_holds_the_bf16_gate(flash_cases, n, s, d):
    q, k, v, want = flash_cases["bf16", n, s, d]
    got = emulated_flash(q, k, v, mm=_mm_bf16, p_bf16=True)
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want,
                               **BF16_TOL)


# -- the int8 stem -------------------------------------------------------


def _assert_int8_close(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= SHARE_EQUAL


def _bn(rng, eps):
    """An eval BatchNorm2d with seeded statistics and its JAX arrays."""
    bn = torch.nn.BatchNorm2d(64, eps=eps).eval().requires_grad_(False)
    values = [rng.uniform(0.5, 1.5, 64), rng.standard_normal(64) * 0.1,
              rng.standard_normal(64) * 0.1, rng.uniform(0.5, 2.0, 64)]
    for p, val in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                      values):
        p.copy_(_t(val.astype(np.float32)))
    return bn, [jnp.asarray(val.astype(np.float32)) for val in values]


def emulated_stem_q(x, weight, scale, bias, steps, conv):
    """The tensor-core stem: conv(x, w_hi) + conv(x, w_lo) in f32 on the
    exact bf16 input, then the plain version's epilogue and int8 pool."""
    hi, lo = stem.split_bf16(weight)
    y = conv(x, hi.float()) + conv(x, lo.float())
    return stem._quant_pool(y, scale, bias, steps)


def _conv2d(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=3)


def _conv3d(x, w):
    y = F.conv3d(x.unsqueeze(1), w, stride=(1, 2, 2), padding=(2, 3, 3))
    return y.transpose(1, 2).flatten(0, 1)


def _stem_q_2d_case(rng, n, x):
    """(port inputs, Pallas interpret output, XLA int8 stem output) of a 2D
    int8 stem of n trunks on frames ``x``, the rest drawn from ``rng``."""
    kernels = [(rng.standard_normal((7, 7, 3, 64)) * 0.05)
               .astype(np.float32) for _ in range(n)]
    bns = [_bn(rng, 1e-5) for _ in range(n)]
    act_max = (6.0, 4.5)[:n]
    stems = [dict(kernel=jnp.asarray(k), bn_scale=g, bn_bias=b,
                  bn_mean=m, bn_var=v, act_max=jnp.float32(a))
             for k, (_, (g, b, m, v)), a in zip(kernels, bns, act_max)]
    xla = np.concatenate([np.asarray(q) for q, _ in
                          fused_rgb_stem(jnp.asarray(x), stems,
                                         dtype=jnp.float32)], axis=-1)
    sb = jnp.concatenate([fold_bn_quant(*jb, 1e-5, jnp.float32(a))
                          for (_, jb), a in zip(bns, act_max)], axis=1)
    w_flat = jnp.concatenate([flatten_packed_kernel(pack_stem_kernel(k), 384)
                              for k in kernels], axis=1)
    pallas = fused_stem_pool_q(s2d_input(jnp.asarray(x)), w_flat, sb,
                               conv_h=32, conv_w=12, tile_h=8,
                               interpret=True)
    folded = [stem.fold_bn_quant(bn, torch.tensor(a))
              for (bn, _), a in zip(bns, act_max)]
    scale, bias, steps = (torch.cat(part) for part in zip(*folded))
    weight = torch.cat([_t(k.transpose(3, 2, 0, 1)) for k in kernels])
    return (_t(x), weight, scale, bias, steps), np.asarray(pallas), xla


@pytest.fixture(scope="module")
def stem_2d_cases():
    """{n: (port inputs, Pallas interpret output, XLA int8 stem output)}
    for 2D stems of n = 1, 2 trunks on bf16-exact frames."""
    cases = {}
    for n in (1, 2):
        rng = np.random.default_rng(10 + n)
        x = _bf16_exact(rng.standard_normal((2, 64, 48, 3))
                        .astype(np.float32))
        cases[n] = _stem_q_2d_case(rng, n, x)
    return cases


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_int8_stem"])
def test_stem_q_2d_two_part_weights_match_jax(stem_2d_cases, n, ref):
    inputs, pallas, xla = stem_2d_cases[n]
    got = emulated_stem_q(*inputs, conv=_conv2d).numpy()
    assert got.shape == (2, 16, 12, 64 * n)
    _assert_int8_close(got, pallas if ref == "pallas_interpret" else xla)


def test_stem_q_3d_two_part_weights_match_jax():
    """Against the int8 stem of egot2x's inference ``VisualFrontend``
    (conv, BN, ReLU, ``quantize_static``, int8 phase pool), on grey faces
    in [0, 255] as the int8 path feeds them (exact in bf16)."""
    rng = np.random.default_rng(20)
    b, t, hw = 2, 3, 40
    x = rng.integers(0, 256, (b, t, hw, hw)).astype(np.float32)
    k3d = (rng.standard_normal((5, 7, 7, 1, 64)) * 0.01).astype(np.float32)
    bn, (gamma, beta, mean, var) = _bn(rng, 1e-3)
    act_max = 60.0
    y = _Stem3DConv(64).apply({"params": {"kernel": jnp.asarray(k3d)}},
                              jnp.asarray(x)[..., None], packed=True)
    yv = y.reshape(*y.shape[:-1], 2, 64)
    yv = jnp.maximum((yv - mean) * (gamma / jnp.sqrt(var + 1e-3)) + beta, 0)
    yq, _ = jax_quantize(yv.reshape(b * t, *y.shape[2:]),
                         jnp.float32(act_max))
    want = _packed_phase_pool(yq)

    scale, bias, s = stem.fold_bn_quant(bn, torch.tensor(act_max))
    got = emulated_stem_q(_t(x), _t(k3d.transpose(4, 3, 0, 1, 2)), scale,
                          bias, s, conv=_conv3d)
    assert got.shape == (b * t, 10, 10, 64)
    _assert_int8_close(got.numpy(), want)


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def test_quantize_epilogue_is_the_ieee_quotient_rounded():
    """The kernel's quantize on the FP32 pipe equals min(rint(y / s), 127)
    with the IEEE f32 divide, at random values and at the half-integer
    multiples of s where rounding is decided. Each FMA is emulated in
    float64, where its product is exact."""
    rng = np.random.default_rng(40)
    n = 400_000
    s = _f32(rng.uniform(1e-3, 0.2, n))
    scale = _f32(rng.uniform(0.5, 1.5, n))
    bias = _f32(rng.standard_normal(n) * 0.1)
    acc = _f32(rng.standard_normal(n) * 3.0)
    half = _f32((rng.integers(0, 140, n) + 0.5) * s.astype(np.float64))
    acc = np.where(np.arange(n) % 2 == 0, acc,
                   _f32((half.astype(np.float64) - bias) / scale))
    y = np.maximum(_f32(acc.astype(np.float64) * scale + bias), 0)
    r = np.float32(1.0) / s
    q0 = _f32(y.astype(np.float64) * r)
    rem = _f32(y.astype(np.float64) - q0.astype(np.float64) * s)
    q = _f32(rem.astype(np.float64) * r + q0)
    got = (np.minimum(q, np.float32(127)) + np.float32(12582912.0)).view(
        np.uint32) - np.uint32(0x4B400000)
    want = np.minimum(np.rint(y / s), 127).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_split_bf16_holds_the_weight_to_2_pow_16():
    w = torch.from_numpy(np.random.default_rng(30).standard_normal(
        (128, 3, 7, 7)).astype(np.float32))
    hi, lo = stem.split_bf16(w)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert float(((hi.double() + lo.double() - w.double()).abs()
                  / w.double().abs()).max()) <= 2.0 ** -16


@pytest.mark.parametrize("kt, cin, ng, dtype", [
    pytest.param(1, 3, 1, torch.bfloat16, id="1-3-1"),
    pytest.param(1, 3, 2, torch.bfloat16, id="1-3-2"),
    pytest.param(5, 1, 1, torch.bfloat16, id="5-1-1"),
    pytest.param(1, 3, 2, torch.float16, id="1-3-2-fp16"),
    pytest.param(5, 1, 1, torch.float16, id="5-1-1-fp16"),
])
def test_weight_fragments_are_the_mma_b_fragments(kt, cin, ng, dtype):
    """Lane 4 g + t of n-tile nt at k-step s holds B[k][8 nt + g] for k =
    16 s + 2t, +1, +8, +9 (PTX m16n8k16 B fragment), w_hi then w_lo, with
    B's K axis the (kt, kh) runs of (kw, ci) padded to 24 (2D) or 8 (3D):
    bf16 parts (``split_bf16``) for bf16 input, fp16 parts of the scaled
    taps (``split_fp16``) for f32 input."""
    rng = np.random.default_rng(kt * 10 + ng)
    w = _t(rng.standard_normal((ng, kt, 7, 7, cin, 64)).astype(np.float32))
    if dtype == torch.float16:
        w = stem.scale_fp16(w)[0]
    frags = stem.weight_fragments(w, dtype)
    ksteps = 11 if cin == 3 else 18
    run = 24 if cin == 3 else 8
    assert frags.shape == (ng, ksteps, 8, 32, 8)
    assert frags.dtype == dtype
    b = torch.zeros(ng, 16 * ksteps, 64)
    for a in range(kt):
        for kh in range(7):
            for kw in range(7):
                for ci in range(cin):
                    b[:, (a * 7 + kh) * run + kw * cin + ci] = w[:, a, kh,
                                                                kw, ci]
    hi, lo = (stem.split_fp16 if dtype == torch.float16
              else stem.split_bf16)(b)
    s_, nt, lane = np.meshgrid(np.arange(ksteps), np.arange(8),
                               np.arange(32), indexing="ij")
    k0, n = 16 * s_ + 2 * (lane % 4), 8 * nt + lane // 4
    for j, dk in enumerate((0, 1, 8, 9)):
        for part, off in ((hi, 0), (lo, 4)):
            want = part[:, torch.from_numpy(k0 + dk), torch.from_numpy(n)]
            assert torch.equal(frags[..., off + j], want)


def test_kernel_weights_are_made_once_per_weight():
    """The wrapper's cache: the same weight gives the same prepared tensor;
    an in-place edit (a new version) makes it anew."""
    weight = torch.randn(128, 3, 7, 7)
    w_taps = weight.reshape(2, 64, 3, 7, 7).permute(0, 3, 4, 2, 1)  # as 2D
    first = stem._kernel_weights(2, w_taps, torch.bfloat16)
    assert stem._kernel_weights(2, w_taps, torch.bfloat16) is first
    assert first[1] is None
    f32 = stem._kernel_weights(2, w_taps, torch.float32)
    assert f32 is not first and f32[0].dtype == torch.float16
    assert f32[1].shape == (128,)
    with torch.no_grad():
        weight.mul_(2.0)
    again = stem._kernel_weights(2, w_taps, torch.bfloat16)
    assert again is not first
    torch.testing.assert_close(
        again[0], stem.weight_fragments(w_taps.reshape(2, 1, 7, 7, 3, 64)),
        rtol=0, atol=0)


# -- the stems' f32 input (3xFP16) and the bf16 float stem -----------------

STEM_F32_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_pallas_stem.py's
STEM_BF16_TOL = dict(rtol=1e-2, atol=1e-2)

# the products each scheme sums: (part of x, part of w), 0 = hi, 1 = lo
SCHEMES = {
    "3xfp16": ("fp16", [(0, 0), (0, 1), (1, 0)]),   # the f32-input kernel
    "1xfp16": ("fp16", [(0, 0)]),
    "bf16_hi_lo": ("bf16", [(0, 0), (0, 1), (1, 0)]),
    "bf16_input": ("bf16_w", [(0, 0), (0, 1)]),    # the bf16-input kernel
}


def _tile_halos(x, kind):
    """The kernel's work items: each 7 x 7 pooled tile's input halo (35 x 35
    pixels, x 5 frames of the clip for 3D, zeros outside the frame and the
    clip) as (tiles, C, [5,] 35, 35), and (Hc, Wc, Ho, Wo, tiles_h,
    tiles_w)."""
    h, w = (x.shape[1], x.shape[2]) if kind == "2d" else x.shape[2:]
    hc, wc = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    ho, wo = (hc - 1) // 2 + 1, (wc - 1) // 2 + 1
    th, tw = -(-ho // 7), -(-wo // 7)
    pad = (5, 28 * tw + 25 - w, 5, 28 * th + 25 - h)   # tile p: rows 28 p - 5..
    if kind == "2d":
        xp = F.pad(x.permute(0, 3, 1, 2), pad)
        halos = xp.unfold(2, 35, 28).unfold(3, 35, 28).permute(0, 2, 3, 1, 4,
                                                                5)
        halos = halos.reshape(-1, x.shape[3], 35, 35)
    else:   # per clip: temporal zero-pad 2
        xp = F.pad(x, pad + (2, 2))
        halos = xp.unfold(1, 5, 1).unfold(2, 35, 28).unfold(3, 35, 28)
        halos = halos.reshape(-1, 1, 5, 35, 35)
    return halos, (hc, wc, ho, wo, th, tw)


def _per(v, like):
    """(len,) -> broadcast over the trailing dims of ``like``."""
    return v.reshape(-1, *([1] * (like.dim() - 1)))


def emulated_stem_tc(x, weight, scale, bias, kind, scheme="3xfp16",
                     qscale=None):
    """The tensor-core stem tile by tile. 3xfp16: each tile's halo scaled
    by its 2^-e_x and each output channel's weights by 2^-e_w
    (``ops.stem.pow2_exponent``), both split into fp16 hi + lo, the
    scheme's products summed in f32 (fp16 products are exact in f32), the
    epilogue's scale 2^e_w 2^e_x. Then BN, ReLU (and with ``qscale`` the
    int8 quantizer), zeros outside the image, the 3x3/2 pool of the 15 x 15
    conv tile."""
    halos, (hc, wc, ho, wo, th, tw) = _tile_halos(x.float(), kind)
    split, products = SCHEMES[scheme]
    w = weight.float()
    fx, fw = torch.ones(halos.shape[0]), torch.ones(w.shape[0])
    if split == "fp16":
        e_x = stem.pow2_exponent(halos.abs().amax(
            dim=tuple(range(1, halos.dim()))))
        fx = stem.pow2(e_x)
        x_parts = stem.split_fp16(halos * _per(stem.pow2(-e_x), halos))
        taps, fw = stem.scale_fp16(w.movedim(0, -1).unsqueeze(0))
        fw = fw[0]
        w_parts = stem.split_fp16(taps[0].movedim(-1, 0))
    elif split == "bf16":
        x_parts, w_parts = stem.split_bf16(halos), stem.split_bf16(w)
    else:
        x_parts, w_parts = (halos,), stem.split_bf16(w)
    if kind == "2d":
        conv = lambda a, b: F.conv2d(a.float(), b.float(), stride=2)
    else:
        conv = lambda a, b: F.conv3d(a.float(), b.float(),
                                     stride=(1, 2, 2))[:, :, 0]
    acc = sum(conv(x_parts[i], w_parts[j]) for i, j in reversed(products))
    s_eff = (scale.float() * fw)[None, :, None, None] * _per(fx, acc)
    y = torch.relu(acc * s_eff + bias.float()[None, :, None, None])
    if qscale is not None:
        s = qscale.float().repeat_interleave(64)[None, :, None, None]
        y = torch.clamp(torch.round(y / s), -127, 127)
    tile = torch.arange(halos.shape[0]) % (th * tw)
    r = torch.arange(15)
    cr = 14 * (tile // tw)[:, None] - 1 + r
    cc = 14 * (tile % tw)[:, None] - 1 + r
    inside = (((cr >= 0) & (cr < hc))[:, :, None]
              & ((cc >= 0) & (cc < wc))[:, None, :])
    pooled = F.max_pool2d(y * inside[:, None], 3, 2)       # (tiles, C, 7, 7)
    c = pooled.shape[1]
    out = pooled.reshape(-1, th, tw, c, 7, 7).permute(0, 1, 4, 2, 5, 3)
    out = out.reshape(-1, 7 * th, 7 * tw, c)[:, :ho, :wo]
    return out.to(torch.int8) if qscale is not None else out


def _stem_case(kind, frames, dtype=jnp.float32):
    """Port inputs of a float stem and ``fused_stem_pool``'s output in
    interpret mode (as tests/test_pallas_stem.py runs it) for frames
    "normalized" (N(0, 1)) or "raw" (0-255 integers, as uint8 frames
    arrive), weights N(0, 1 / fan-in); bf16 ``dtype`` rounds the frames
    and runs the Pallas kernel in bf16."""
    rng = np.random.default_rng(50 + len(frames) + (kind == "3d"))
    if kind == "2d":
        shape, taps, fan, eps = (2, 64, 64, 3), (7, 7, 3, 64), 147, 1e-5
    else:
        shape, taps, fan, eps = (1, 6, 32, 32), (5, 7, 7, 1, 64), 245, 1e-3
    x = (rng.standard_normal(shape) if frames == "normalized"
         else rng.integers(0, 256, shape)).astype(np.float32)
    if dtype == jnp.bfloat16:
        x = _bf16_exact(x)
    k = (rng.standard_normal(taps) / np.sqrt(fan)).astype(np.float32)
    bn, (gamma, beta, mean, var) = _bn(rng, eps)
    sb = fold_bn(gamma, beta, mean, var, eps)
    hw = shape[-2]
    if kind == "2d":
        w_flat = flatten_packed_kernel(pack_stem_kernel(k), 384)
        xp = s2d_input(jnp.asarray(x, dtype))
        weight = _t(k.transpose(3, 2, 0, 1))
    else:
        w_flat = flatten_packed_kernel(pack_stem_kernel_3d(k), 512)
        xp = s2d_input_3d(jnp.asarray(x, dtype))
        weight = _t(k.transpose(4, 3, 0, 1, 2))
    want = fused_stem_pool(xp, w_flat.astype(dtype), sb, conv_h=hw // 2,
                           conv_w=hw // 4, tile_h=8, interpret=True)
    scale, bias = stem.fold_bn(bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, eps)
    return (_t(x), weight, scale, bias), np.asarray(want, np.float32)


@pytest.fixture(scope="module")
def stem_float_cases():
    """{(kind, frames): (port inputs, Pallas interpret output)}: 2D at 2 x
    64^2 frames and 3D at one clip of 6 x 32^2, f32 (normalized and raw
    frames) and bf16 (normalized)."""
    cases = {(kind, frames): _stem_case(kind, frames)
             for kind in ("2d", "3d") for frames in ("normalized", "raw")}
    for kind in ("2d", "3d"):
        cases[kind, "bf16"] = _stem_case(kind, "normalized", jnp.bfloat16)
    return cases


@pytest.mark.parametrize("frames", ["normalized", "raw"])
@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_3xfp16_holds_the_f32_gate(stem_float_cases, kind, frames):
    """The f32-input kernel's arithmetic against ``fused_stem_pool`` in
    interpret mode, rtol = atol = 1e-4, on normalized frames and on raw
    0-255 frames (whose ~100x larger sums the f32 reference itself holds
    only to about half the gate)."""
    inputs, want = stem_float_cases[kind, frames]
    got = emulated_stem_tc(*inputs, kind)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **STEM_F32_TOL)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_one_fp16_pass_misses_the_f32_gate(stem_float_cases, kind):
    """Why three products: one fp16 pass (11 significant bits, as one TF32
    pass) breaks the f32 gate already on normalized frames at this
    module's smallest sizes, 2 frames of 64^2 and one 6-frame clip of
    32^2."""
    inputs, want = stem_float_cases[kind, "normalized"]
    got = emulated_stem_tc(*inputs, kind, scheme="1xfp16").numpy()
    assert not np.allclose(got, want, **STEM_F32_TOL)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_bf16_hi_lo_misses_the_f32_gate_on_raw_frames(stem_float_cases,
                                                           kind):
    """Why fp16 and not bf16 parts: bf16 hi + lo keeps 16 significant
    bits, enough on normalized frames but not on raw 0-255 frames, whose
    large sums need the 22 of fp16 hi + lo. The miss shows at this
    module's smallest sizes, 2 frames of 64^2 and one 6-frame clip of
    32^2."""
    inputs, want = stem_float_cases[kind, "normalized"]
    np.testing.assert_allclose(
        emulated_stem_tc(*inputs, kind, scheme="bf16_hi_lo").numpy(), want,
        **STEM_F32_TOL)
    inputs, want = stem_float_cases[kind, "raw"]
    got = emulated_stem_tc(*inputs, kind, scheme="bf16_hi_lo").numpy()
    assert not np.allclose(got, want, **STEM_F32_TOL)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_stem_bf16_two_part_weights_hold_the_bf16_gate(stem_float_cases,
                                                       kind):
    """The bf16-input float stem: the exact bf16 frames times w_hi + w_lo
    in f32, rounded to bf16 once, against the Pallas kernel run in bf16
    (bf16 weights, a bf16 conv map), rtol = atol = 1e-2."""
    inputs, want = stem_float_cases[kind, "bf16"]
    got = emulated_stem_tc(*inputs, kind, scheme="bf16_input")
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want,
                               **STEM_BF16_TOL)


def test_stem_3xfp16_takes_a_zero_tile():
    """An all-zero frame beside a normal one: its tiles' max is 0, their
    exponent -15 (frexp(0) has exponent 0), and the output is the plain
    version's pooled ReLU(bias)."""
    rng = np.random.default_rng(60)
    x = rng.standard_normal((2, 40, 36, 3)).astype(np.float32)
    x[0] = 0.0
    weight = _t((rng.standard_normal((64, 3, 7, 7)) / np.sqrt(147))
                .astype(np.float32))
    bn, _ = _bn(rng, 1e-5)
    scale, bias = stem.fold_bn(bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, 1e-5)
    got = emulated_stem_tc(_t(x), weight, scale, bias, "2d")
    want = stem.stem_pool_2d_plain(_t(x), weight, scale, bias)
    torch.testing.assert_close(got, want, **STEM_F32_TOL)
    torch.testing.assert_close(got[0], torch.relu(bias).expand_as(got[0]),
                               rtol=0, atol=0)
    assert int(stem.pow2_exponent(torch.zeros(1))) == -15


def test_pow2_exponent_scales_into_fp16s_top_binade():
    """max |x 2^-e| in [2^14, 2^15) for maxima from 2^-48 up to the f32
    max, hi + lo round-trips to 2^-22 (or fp16's subnormal step), and for
    every pair of maxima whose product is finite in f32 the epilogue's
    2^(e_x + e_w) is a normal f32 power of two."""
    rng = np.random.default_rng(70)
    m = torch.from_numpy(np.concatenate([
        np.exp2(rng.uniform(-48, 127.9, 2000)),
        [2.0 ** -48, 1.0, 2.0 ** 14, 2.0 ** 15 - 1, 255.0, 1e6,
         np.finfo(np.float32).max]]).astype(np.float32))
    e = stem.pow2_exponent(m)
    top = m.double() * torch.exp2(-e.double())
    assert bool(((top >= 2.0 ** 14) & (top < 2.0 ** 15)).all())
    torch.testing.assert_close(stem.pow2(e).double(), torch.exp2(e.double()),
                               rtol=0, atol=0)
    tiny = torch.tensor([0.0, 1e-30, 2.0 ** -149])   # never below E_MIN
    assert bool((stem.pow2_exponent(tiny) >= stem.E_MIN).all())
    # the split of a scaled tile
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    x[:100] *= 1e-9                       # far below the tile's max
    e_x = stem.pow2_exponent(x.abs().max())
    xs = x * stem.pow2(-e_x)
    hi, lo = stem.split_fp16(xs)
    err = (hi.double() + lo.double() - xs.double()).abs()
    assert bool((err <= torch.clamp(xs.double().abs() * 2.0 ** -22,
                                    min=2.0 ** -25)).all())
    # 2^(e_x + e_w) for maxima whose product is finite
    mx, mw = torch.meshgrid(m, m[::20], indexing="ij")
    finite = torch.isfinite(mx * mw) & (mx * mw > 0)
    total = stem.pow2_exponent(mx) + stem.pow2_exponent(mw)
    assert bool(((total[finite] >= -126) & (total[finite] <= 127)).all())


@pytest.fixture(scope="module")
def stem_2d_f32_cases():
    """{n: (port inputs, Pallas interpret output, XLA int8 stem output)}
    for 2D int8 stems of n = 1, 2 trunks on f32 frames."""
    cases = {}
    for n in (1, 2):
        rng = np.random.default_rng(30 + n)
        x = rng.standard_normal((2, 64, 48, 3)).astype(np.float32)
        cases[n] = _stem_q_2d_case(rng, n, x)
    return cases


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_int8_stem"])
def test_stem_q_2d_f32_input_3xfp16_matches_jax(stem_2d_f32_cases, n, ref):
    """The int8 epilogue on the f32-input body: one quantum, >= 99.9%
    equal, as the bf16-input kernel is held."""
    (x, weight, scale, bias, steps), pallas, xla = stem_2d_f32_cases[n]
    got = emulated_stem_tc(x, weight, scale, bias, "2d", qscale=steps)
    assert got.shape == (2, 16, 12, 64 * n)
    _assert_int8_close(got.numpy(),
                       pallas if ref == "pallas_interpret" else xla)


def test_stem_q_3d_f32_input_3xfp16_matches_jax():
    """Against the int8 stem of egot2x's inference ``VisualFrontend`` on f32
    grey faces in [0, 255] that are not whole numbers."""
    rng = np.random.default_rng(21)
    b, t, hw = 2, 3, 40
    x = rng.uniform(0, 255, (b, t, hw, hw)).astype(np.float32)
    k3d = (rng.standard_normal((5, 7, 7, 1, 64)) * 0.01).astype(np.float32)
    bn, (gamma, beta, mean, var) = _bn(rng, 1e-3)
    act_max = 60.0
    y = _Stem3DConv(64).apply({"params": {"kernel": jnp.asarray(k3d)}},
                              jnp.asarray(x)[..., None], packed=True)
    yv = y.reshape(*y.shape[:-1], 2, 64)
    yv = jnp.maximum((yv - mean) * (gamma / jnp.sqrt(var + 1e-3)) + beta, 0)
    yq, _ = jax_quantize(yv.reshape(b * t, *y.shape[2:]),
                         jnp.float32(act_max))
    want = _packed_phase_pool(yq)

    scale, bias, s = stem.fold_bn_quant(bn, torch.tensor(act_max))
    got = emulated_stem_tc(_t(x), _t(k3d.transpose(4, 3, 0, 1, 2)), scale,
                           bias, "3d", qscale=s)
    assert got.shape == (b * t, 10, 10, 64)
    _assert_int8_close(got.numpy(), want)
