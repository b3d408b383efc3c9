"""ts_pnr with int8 trunks against the JAX package's in bf16
(``tools/bench_hoi.py``'s default: ``QUANT=1``, bf16 compute).

The geometry, weights, calibration and teacher-forced JAX twin of
``tests/test_torch_port_quant3d_ts.py`` (``ts_run``), in bf16 on both
sides. The int8 convs take bf16 maps, quantize them in f32 and dequantize
to bf16, as the JAX package does.

Tolerances: each int8 conv's output within 2^-7 relative (one bf16 ulp)
of JAX's and the input JAX computed itself within 2^-6 (1 + |x|) of the
port's (a bf16 BN rounds apart by an ulp or two) on all but 20% of the
elements, and each output at cosine > 0.9999: bf16's coarse maps hit
the quantizer's ties k + 1/2 often, and XLA's reordered divide rounds
some of them the other way; a flipped input moves every output of its
window, so the share off runs high (measured at most 7.0% and 0.04% of
the elements, 5.3% at 2 clips; conv cosine 1 - 1.8e-6 at worst): the
conv cosine bounds what they move. Logits at cosine > 0.999, the bar the
JAX package holds bf16 int8 paths to (tests/test_fused_stem.py:63), and
within 0.05 (1 + |logit|) (tests/test_torch_port_hoi_translators.py's
bf16 bar; measured cosine 0.999986, max |diff| 0.0089 of logits up to
1.80).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_quant3d_trunks import (assert_forced_match,  # noqa: E402
                                            cosine)
from test_torch_port_quant3d_ts import B, ts_run  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

OUT_RTOL, IN_TOL, FLIP_SHARE = 2.0 ** -7, 2.0 ** -6, 0.2
COSINE, CONV_COSINE, LOGIT_TOL = 0.999, 0.9999, 0.05


def test_ts_pnr_int8_bf16_matches_jax():
    run = ts_run(torch.bfloat16)
    got, want = run["got"], run["want"]
    assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape == (B, 16) and np.isfinite(got).all()
    assert len(run["seen"]) == 208
    assert_forced_match(run["seen"], run["jax_seen"], OUT_RTOL, IN_TOL,
                        FLIP_SHARE, CONV_COSINE)
    assert (np.abs(got - want) <= LOGIT_TOL * (1 + np.abs(want))).all()
    assert cosine(got, want) > COSINE
