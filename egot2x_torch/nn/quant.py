"""int8 static-PTQ inference of the conv trunks.

Counterpart of ``egot2x/nn/quant.py``: ``QuantConv2d`` is its ``QuantConv``
(the HHI trunks), ``QuantConv3d`` its ``QuantConv3D`` (the HOI trunks'
stage convs):

  * weights: symmetric per-output-channel int8, ``s_w = max|W| / 127``
    over (C_in, kh, kw) or (C_in, kt, kh, kw) (HWIO's and THWIO's
    (kh, kw, ci) and (kt, kh, kw, ci)), quantized once from the f32
    parameters after they are loaded, not on every call;
  * activations: symmetric per-tensor int8 with a static scale,
    ``s = max(act_max, 1e-6) / 127``, where ``act_max`` is a running
    max-abs recorded by :func:`calibrate` on the float path;
  * int8 x int8 accumulates exactly in int32 (``ops.int8.conv2d_int8``,
    ``ops.int8.conv3d_int8``) and dequantizes as
    ``acc.float() * (s_act * s_w)``, then casts to the compute dtype.

The scales are buffers (``act_max`` of each :class:`QuantConv2d` and
:class:`QuantConv3d`, ``stem_act_max`` of each stem, ``out_act_max`` of
each block that emits int8), so ``state_dict`` and the weight bridge carry
them. Modules of a quant model read ``self.calibrating``, which
:func:`calibrate` sets for its passes: then they run the float path end to
end and record their maxima.
"""

from __future__ import annotations

import torch

from egot2x_torch.nn.layers import Conv2d, Conv3d
from egot2x_torch.ops.int8 import conv2d_int8, conv3d_int8, quantize_static

SCALE_BUFFERS = ("act_max", "stem_act_max", "out_act_max")


def quantize_weight(w: torch.Tensor):
    """(O, C, kh, kw) or (O, C, kt, kh, kw) f32 -> (int8 weight, (O,) f32
    step s_w), the step over all but the output axis."""
    s_w = torch.clamp(w.abs().amax(dim=tuple(range(1, w.dim()))),
                      min=1e-12) / 127.0
    step = s_w.view(-1, *(1,) * (w.dim() - 1))
    return torch.round(w / step).to(torch.int8), s_w


def record_max(buf: torch.Tensor, x: torch.Tensor) -> None:
    """buf <- max(buf, max|x|), in place, f32."""
    buf.copy_(torch.maximum(buf, x.detach().abs().max().float()))


class _Int8Weight:
    """The int8 weight of a quant conv, with its activation scale buffer
    ``act_max`` and the ``calibrating`` flag."""

    def _init_quant(self):
        self.register_buffer("act_max", torch.zeros(()))
        self.calibrating = False
        self._int8 = None   # (key of the weight it came from, wq, s_w)

    def int8_weight(self):
        """(wq, s_w), quantized once per weight: the cache is keyed on the
        parameter's storage and version counter, so ``load_state_dict``,
        an in-place edit or a move to another device refreshes it."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._int8 is None or self._int8[0] != key:
            with torch.no_grad():
                wq, s_w = quantize_weight(w.float())
            self._int8 = (key, wq.contiguous(), s_w)
        return self._int8[1:]


class QuantConv2d(_Int8Weight, Conv2d):
    """A bias-free 2D conv with the int8 static-PTQ inference mode. Its
    parameters are ``nn.Conv2d``'s, so checkpoints load unchanged; its
    activation scale is the buffer ``act_max``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, bias=False, **kwargs)
        self._init_quant()
        self.compute_dtype = compute_dtype

    def forward(self, x, in_scale=None):
        """``x`` float, or int8 quantized upstream with step ``in_scale``
        (then the conv consumes it as it is). Returns the compute dtype."""
        if self.calibrating:
            if x.dtype == torch.int8:
                raise ValueError("calibration runs the float path end to end")
            record_max(self.act_max, x)
            return super().forward(x)
        if x.dtype == torch.int8:
            xq, s_act = x, in_scale
        else:
            xq, s_act = quantize_static(x, self.act_max)
        wq, s_w = self.int8_weight()
        acc = conv2d_int8(xq, wq, self.stride[0], self.padding[0])
        return (acc.float() * (s_act * s_w)[:, None, None]).to(
            self.compute_dtype)


class QuantConv3d(_Int8Weight, Conv3d):
    """A bias-free 3D conv with the int8 static-PTQ inference mode of the
    JAX package's ``QuantConv3D``. Its parameters are ``nn.Conv3d``'s, so
    float checkpoints load unchanged; its activation scale is the buffer
    ``act_max``. Calibrating, it records max|x| (f32) of the input as given
    and runs the float conv in the input's dtype (the JAX calibrate path
    casts input and kernel to its dtype); otherwise it quantizes the input,
    convolves in int8 and dequantizes to the input's dtype, the compute
    dtype of the trunk's maps. Dilation 1 only (all the trunks use)."""

    channels_last = True   # build_model keeps the weight channels_last_3d

    def __init__(self, *args, **kwargs):
        super().__init__(*args, bias=False, **kwargs)
        if self.dilation != (1, 1, 1):
            raise ValueError(f"int8 3D conv: dilation {self.dilation}, "
                             "only 1 is ported")
        self._init_quant()

    def forward(self, x):
        if self.calibrating:
            record_max(self.act_max, x)
            return super().forward(x)
        xq, s_act = quantize_static(x, self.act_max)
        wq, s_w = self.int8_weight()
        acc = conv3d_int8(xq, wq, self.stride, self.padding)
        return (acc.float() * (s_act * s_w)[:, None, None, None]).to(
            x.dtype)


def scale_buffers(model: torch.nn.Module):
    """(name, tensor) of every calibrated scale of ``model``."""
    return [(name, buf) for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in SCALE_BUFFERS]


def assert_calibrated(model: torch.nn.Module) -> None:
    """Raise when a quant model would run with an uncalibrated scale
    (act_max == 0: every activation clips to +-127, with no error)."""
    bad = [name for name, buf in scale_buffers(model) if float(buf) <= 0.0]
    if bad:
        raise ValueError(
            f"{len(bad)} int8 activation scale(s) are uncalibrated "
            f"(act_max == 0), e.g. {bad[0]}; run "
            "egot2x_torch.nn.quant.calibrate on a representative batch "
            "before int8 inference")


class ChecksCalibration:
    """For a quant model's top module: ``assert_calibrated_once`` before an
    int8 forward."""

    _checked_scales = None

    def assert_calibrated_once(self):
        """``assert_calibrated`` once for each state of the scales: the
        check reads every scale on the host, so it reruns only after a
        scale was written or moved."""
        bufs = [b for _, b in scale_buffers(self)]
        key = [(b.data_ptr(), b._version) for b in bufs]
        if key != self._checked_scales:
            assert_calibrated(self)
            self._checked_scales = key


@torch.no_grad()
def calibrate(model: torch.nn.Module, *inputs, n_passes: int = 1):
    """Run ``model(*inputs)`` on its float path ``n_passes`` times and
    record every activation scale as a running max-abs (what
    ``egot2x.nn.quant.calibrate_variables`` does). Returns ``model``."""
    flagged = [m for m in model.modules() if hasattr(m, "calibrating")]
    for m in flagged:
        m.calibrating = True
    try:
        for _ in range(max(n_passes, 1)):
            model(*inputs)
    finally:
        for m in flagged:
            m.calibrating = False
    return model
