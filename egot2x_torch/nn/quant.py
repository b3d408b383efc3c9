"""int8 static-PTQ inference of the conv trunks.

Counterpart of ``egot2x/nn/quant.py``, 2D only (``QuantConv3D`` is HOI):

  * weights: symmetric per-output-channel int8, ``s_w = max|W| / 127``
    over (C_in, kh, kw) (HWIO's (kh, kw, ci)), quantized once from the f32
    parameters after they are loaded, not on every call;
  * activations: symmetric per-tensor int8 with a static scale,
    ``s = max(act_max, 1e-6) / 127``, where ``act_max`` is a running
    max-abs recorded by :func:`calibrate` on the float path;
  * int8 x int8 accumulates exactly in int32 (``ops.int8.conv2d_int8``)
    and dequantizes as ``acc.float() * (s_act * s_w)``, then casts to the
    compute dtype.

The scales are buffers (``act_max`` of each :class:`QuantConv2d`,
``stem_act_max`` of each stem, ``out_act_max`` of each block that emits
int8), so ``state_dict`` and the weight bridge carry them. Modules of a
quant model read ``self.calibrating``, which :func:`calibrate` sets for
its passes: then they run the float path end to end and record their
maxima.
"""

from __future__ import annotations

import torch

from egot2x_torch.nn.layers import Conv2d
from egot2x_torch.ops.int8 import conv2d_int8, quantize_static

SCALE_BUFFERS = ("act_max", "stem_act_max", "out_act_max")


def quantize_weight(w: torch.Tensor):
    """(O, C, kh, kw) f32 -> (int8 weight, (O,) f32 step s_w)."""
    s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    return torch.round(w / s_w[:, None, None, None]).to(torch.int8), s_w


def record_max(buf: torch.Tensor, x: torch.Tensor) -> None:
    """buf <- max(buf, max|x|), in place, f32."""
    buf.copy_(torch.maximum(buf, x.detach().abs().max().float()))


class QuantConv2d(Conv2d):
    """A bias-free 2D conv with the int8 static-PTQ inference mode. Its
    parameters are ``nn.Conv2d``'s, so checkpoints load unchanged; its
    activation scale is the buffer ``act_max``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, bias=False, **kwargs)
        self.register_buffer("act_max", torch.zeros(()))
        self.compute_dtype = compute_dtype
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
