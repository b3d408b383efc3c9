"""The port's int8 HOI trunk against the JAX package's, at narrow width,
and the teacher-forced comparison the int8 tests share.

``ResNet3D`` as ``StateChangeClsResNet`` builds its trunk (``slow_layer5``,
depth 50, raw [0, 255] frames: ``input_norm=None``) at
``tests/test_torch_port_resnet3d.py``'s small widths: ``width_per_group``
4 (stage widths 16-128), crop 65, 4 uint8 frames, 2 clips. (SlowFast's
int8 trunk is held at full width, its only one, inside ts_pnr's run:
tests/test_torch_port_quant3d_ts.py.)

Weights: ``random_jax_variables`` of the float trunk through the bridge,
the ResNet3D stem's BN statistics fitted to a calibration batch by precise
BN on the float trunk (raw pixels blow the drawn ones up:
tests/test_torch_port_resnet3d.py), before any calibration; the int8 trunk
loads that state. The ResNet3D's activation scales are JAX's
(``calibrate_variables``), carried through the bridge's ``quant``
collection; the port's own ``calibrate`` on the same batch must reproduce
them. f32 on the CPU, the JAX side jitted.

Why the JAX side is teacher-forced (``forced_apply``): a value within one
f32 rounding of a quantization boundary lands on either side in the two
packages (their convs and BNs round apart), and the flipped quantum moves
everything after it; over 16 blocks that leaves the free-running trunks
at cosine 0.99989 here (0.9994 at full width; the port against itself
with its stem output moved by 1e-4, the two packages' rounding gap on raw
pixels, reads 0.9997). So each JAX ``QuantConv3D`` is fed the input the
port's ``QuantConv3d`` at the same path took, and the two are held conv
by conv. Even so an input can land a quantum apart: jitted, XLA rewrites
the quantizer's ``x / (act_max / 127)`` into another order of operations,
so a quotient within an ulp of k + 1/2 rounds the other way (one element
in ~10^5 in f32, more often in bf16, whose coarse inputs hit ties; the
port divides as the JAX source says). Hence each conv: its output within
rtol 1e-6 of JAX's (the same integer accumulator and f32 products; one
ulp where XLA rounds the dequantizing product apart) and the input JAX
computed itself (its own BNs, ReLUs, residuals and laterals on the forced
convs' outputs) within 1e-4 (1 + |x|) of the port's, each on all but at
most 2% of the elements (measured: none off here; up to 0.99% and 0.38%
in ts_pnr), and the output at cosine > 0.9999 (measured 1 - 2e-15 at
worst); the trunk's output at cosine > 0.9999 (measured 1 - 4e-15, max
|diff| 1.9e-6 of maps up to 12.6). Scales rtol 1e-5 (max-abs of the same f32
activations; measured 6.9e-7); the int8 trunk against its float self at
cosine > 0.99, the JAX package's own bar (tests/test_quant_3d.py:57;
measured 0.99967).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as flax_nn

torch = pytest.importorskip("torch")

from egot2x.nn import resnet3d as jax_r3d  # noqa: E402
from egot2x.nn.quant import QuantConv3D  # noqa: E402
from egot2x.nn.quant import assert_calibrated as jax_assert  # noqa: E402
from egot2x.nn.quant import calibrate_variables  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import place  # noqa: E402
from egot2x_torch.nn import resnet3d  # noqa: E402
from egot2x_torch.nn.quant import (  # noqa: E402
    QuantConv3d, assert_calibrated, calibrate, scale_buffers)
from egot2x_torch.train.precise_bn import (  # noqa: E402
    compute_precise_bn_stats)
from test_torch_port_train import _one_thread  # noqa: E402,F401

B, T, CROP = 2, 4, 65
R3D = dict(arch="slow_layer5", depth=50, width_per_group=4, input_norm=None)
SEED = 11
COSINE, OUT_RTOL, IN_TOL, SCALE_RTOL, VS_FLOAT = (0.9999, 1e-6, 1e-4, 1e-5,
                                                  0.99)
FLIP_SHARE = 0.02


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def nthwc(x):
    return x.permute(0, 2, 3, 4, 1).float().numpy()


def int8_twin(model, float_model):
    """Load ``float_model``'s state into the int8 ``model``; its scales
    stay 0."""
    missing, unexpected = model.load_state_dict(float_model.state_dict(),
                                                strict=False)
    assert not unexpected and all(k.endswith("act_max") for k in missing)
    return model


def port_int8_run(model, *args):
    """``model(*args)`` and each ``QuantConv3d``'s (input, output) as
    NTHWC f32 numpy, by its path ("/"-joined, the JAX module's)."""
    seen = {}

    def keep(name):
        return lambda mod, i, o: seen.__setitem__(
            name.replace(".", "/"), (nthwc(i[0]), nthwc(o)))
    hooks = [m.register_forward_hook(keep(name))
             for name, m in model.named_modules()
             if isinstance(m, QuantConv3d)]
    try:
        with torch.no_grad():
            out = model(*args)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def forced_apply(apply, record=()):
    """A jitted ``apply(variables, *args)`` with each ``QuantConv3D``'s
    input replaced by the port's at its path (``port_seen``, from
    ``port_int8_run``; in the conv's dtype); returns (output, {path: (the
    input JAX computed, the conv's output)}, {name: the output of the
    module of each name in ``record``})."""
    def run(variables, forced, *args):
        seen, recorded = {}, {}

        def intercept(next_fun, a, kw, context):
            module = context.module
            if context.method_name != "__call__":
                return next_fun(*a, **kw)
            if not isinstance(module, QuantConv3D):
                y = next_fun(*a, **kw)
                if module.name in record:
                    recorded[module.name] = y
                return y
            path = "/".join(module.path)
            y = next_fun(forced[path].astype(a[0].dtype), *a[1:], **kw)
            seen[path] = (a[0], y)
            return y
        with flax_nn.intercept_methods(intercept):
            out = apply(variables, *args)
        return out, seen, recorded
    run = jax.jit(run)
    return lambda variables, port_seen, *args: run(
        variables, {p: x for p, (x, _) in port_seen.items()}, *args)


def assert_forced_match(port_seen, jax_seen, out_rtol=OUT_RTOL,
                        in_tol=IN_TOL, flip_share=FLIP_SHARE,
                        conv_cosine=COSINE):
    """Every int8 conv: its output within ``out_rtol`` of JAX's and the
    input JAX computed itself within ``in_tol`` (1 + |x|) of the port's,
    but for at most ``flip_share`` of the elements of each (where an input
    lands a quantum apart: XLA reassociates the quantizer's divide, module
    docstring), and the output at cosine > ``conv_cosine``."""
    assert sorted(port_seen) == sorted(jax_seen)
    for path, (x, y) in port_seen.items():
        own, want = (np.asarray(a, np.float32) for a in jax_seen[path])
        assert y.shape == want.shape and own.shape == x.shape, path
        off_out = np.abs(y - want) > out_rtol * np.abs(want)
        off_in = np.abs(own - x) > in_tol * (1 + np.abs(x))
        assert off_out.mean() <= flip_share, (path, off_out.mean())
        assert off_in.mean() <= flip_share, (path, off_in.mean())
        assert cosine(y, want) > conv_cosine, path


@pytest.fixture(scope="module")
def r3d():
    rng = np.random.default_rng(SEED)
    x, cal = (rng.integers(0, 256, (B, T, CROP, CROP, 3)).astype(np.uint8)
              for _ in range(2))
    fm = place(resnet3d.ResNet3D(**R3D), "cpu")
    bridge.load_jax_variables(fm, bridge.random_jax_variables(fm, SEED))
    compute_precise_bn_stats(fm, [(torch.from_numpy(cal),)], 1,
                             bns=[fm.s1.bn])
    port = int8_twin(place(resnet3d.ResNet3D(quant=True, **R3D), "cpu"), fm)
    jm = jax_r3d.ResNet3D(quant=True, **R3D)
    variables = calibrate_variables(jm, bridge.to_jax_variables(port),
                                    jnp.asarray(x))
    jax_assert(variables)
    theirs = place(resnet3d.ResNet3D(quant=True, **R3D), "cpu")
    bridge.load_jax_variables(theirs, variables)
    got, seen = port_int8_run(theirs, torch.from_numpy(x))
    want, jax_seen, _ = forced_apply(jm.apply)(variables, seen,
                                               jnp.asarray(x))
    with torch.no_grad():
        got_float = fm(torch.from_numpy(x))
        calibrate(port, torch.from_numpy(x))
    return dict(got=got, want=want, seen=seen, jax_seen=jax_seen,
                got_float=got_float, port=port, variables=variables)


def test_resnet3d_int8_matches_jax(r3d):
    got = nthwc(r3d["got"])
    assert got.shape == (B, T, 3, 3, 128) and np.isfinite(got).all()
    assert len(r3d["seen"]) == 52   # the stem, heads, Nonlocals: float
    assert_forced_match(r3d["seen"], r3d["jax_seen"])
    assert cosine(got, r3d["want"]) > COSINE


def test_calibrate_reproduces_jax_scales(r3d):
    ours = {name: float(buf) for name, buf in scale_buffers(r3d["port"])}
    theirs = {".".join(k[:-1]) + ".act_max": float(v) for k, v in
              bridge._flatten(r3d["variables"]["quant"]).items()}
    assert sorted(ours) == sorted(theirs) and len(ours) == 52
    for name, s in theirs.items():
        assert s > 0
        np.testing.assert_allclose(ours[name], s, rtol=SCALE_RTOL,
                                   err_msg=name)
    assert_calibrated(r3d["port"])


def test_int8_trunk_tracks_float(r3d):
    assert cosine(r3d["got"].numpy(), r3d["got_float"].numpy()) > VS_FLOAT
