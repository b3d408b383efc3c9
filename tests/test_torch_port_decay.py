"""The port's weight-decay rule against the JAX package's mask.

``egot2x/train/optim.py::_norm_bias_mask`` decays every leaf with two or
more axes (``ndim >= 2``) in the JAX layout. ``egot2x_torch/train/optim.py``
decays a parameter of two or more axes but for the leaves it stores with
extra unit axes (gLN's (1, C, 1) scale and offset, (C,) in JAX). Over
every model the weight bridge carries, at small widths on the CPU, the
port's decay set is the mask on the same tree (each port parameter against
the JAX leaves it maps to, through ``bridge_rules``); a toy module with a
``Linear(D, 1)`` (a Dense(1) kernel in JAX, (1, D) here) and a (1, 1, D)
token decays both, as JAX does. The models are built on the meta device
and given uninitialized memory (the rule reads shapes only). No JAX
function is jitted.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.train.optim import _norm_bias_mask  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import (MODEL_REGISTRY,  # noqa: E402
                                        register_models)
from egot2x_torch.tasks.asd_2loader import _TranslatorWithHead  # noqa: E402
from egot2x_torch.train.optim import construct_optimizer, decays  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

SMALL = dict(hidden_dim=32, num_heads=4, num_layers=1)
MODELS = {
    "TaskFusionMFTransformer3Task": SMALL,
    "TaskFusionMFTransformer2Task": SMALL,
    "TaskFusionMFTransformer3TaskASD": SMALL,
    "FinetuneASD": {}, "LAM2ASD": {}, "TTM2ASD": {},
    "TalkNetWithHeads": {}, "BaselineLSTM": {}, "GazeLSTM": {},
    "TTMBaselineLSTM": {},
    "TaskTranslationPromptTransformer": dict(SMALL, vocab_size=7),
    "TaskPromptTransformer": dict(SMALL, vocab_size=7),
    "_TranslatorWithHead": SMALL,
}


def _mask(params):
    """JAX leaf path (a tuple of keys) -> the JAX package's decision."""
    tree = _norm_bias_mask(params, decay_on=True)
    return {tuple(k.key for k in path): bool(v) for path, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decay_set_is_the_jax_packages(name):
    register_models()
    cls = (_TranslatorWithHead if name == "_TranslatorWithHead"
           else MODEL_REGISTRY.get(name))
    with torch.device("meta"):
        model = cls(**MODELS[name])
    model = model.to_empty(device="cpu")
    mask = _mask(bridge.to_jax_variables(model)["params"])
    params = dict(model.named_parameters())
    seen = set()
    for key, sources, _ in bridge.bridge_rules(model):
        if key not in params:
            continue   # a statistic or an int8 scale
        jax_says = {mask[path] for coll, path in sources}
        assert jax_says == {decays(key, params[key])}, (key, jax_says)
        seen.add(key)
    assert seen == set(params)
    if name == "TalkNetWithHeads":   # gLN: (1, C, 1) here, (C,) in JAX
        gln = [k for k in params if k.endswith((".gamma", ".beta"))]
        assert gln and not any(decays(k, params[k]) for k in gln)
        assert all(params[k].dim() == 3 for k in gln)


class _Toy(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        self.head = torch.nn.Linear(d, 1)
        self.token = torch.nn.Parameter(torch.zeros(1, 1, d))
        self.norm = torch.nn.LayerNorm(d)


def test_unit_axes_decay_as_in_jax():
    """A Dense(1) kernel and a (1, 1, D) token: ndim >= 2 in JAX, so both
    decay; the bias and the norm do not. The optimizer's groups follow."""
    toy = _Toy()
    jax_params = {"head": {"kernel": np.zeros((8, 1)), "bias": np.zeros(1)},
                  "token": np.zeros((1, 1, 8)),
                  "norm": {"scale": np.zeros(8), "bias": np.zeros(8)}}
    mask = _mask(jax_params)
    names = {"head.weight": ("head", "kernel"), "head.bias": ("head", "bias"),
             "token": ("token",), "norm.weight": ("norm", "scale"),
             "norm.bias": ("norm", "bias")}
    params = dict(toy.named_parameters())
    for key, path in names.items():
        assert decays(key, params[key]) is mask[path], key
    opt = construct_optimizer(params, "adam", lr=1e-3, weight_decay=0.1)
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"]
               for p in g["params"]}
    assert decayed == {id(toy.head.weight), id(toy.token)}
