"""Model registry and ``build_model``, the port's entry point.

The port's own counterpart of ``egot2x/core/registry.py``. Models run on
the CUDA card unless the caller passes ``device="cpu"`` (as the tests do);
with no card and no explicit device, ``build_model`` raises rather than
carry on on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


class Registry:
    """Name -> callable mapping with decorator-style registration."""

    def __init__(self, name: str):
        self.name = name
        self._objs: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None):
        def add(obj):
            key = name or obj.__name__
            if key in self._objs:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._objs[key] = obj
            return obj
        return add

    def __contains__(self, key: str) -> bool:
        return key in self._objs

    def get(self, key: str) -> Any:
        if key not in self._objs:
            known = ", ".join(sorted(self._objs))
            raise KeyError(f"{key!r} not found in registry {self.name}. "
                           f"Known: {known}")
        return self._objs[key]


MODEL_REGISTRY = Registry("MODEL")


def resolve_device(device=None) -> torch.device:
    """``device`` as given (a card without an index: the current one),
    else the current CUDA card; raises when there is no card and no device
    was asked for."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: egot2x_torch runs on the card; "
                           "pass device='cpu' to run the plain path")
    return torch.device("cuda", torch.cuda.current_device())


def build_model(name: str, device=None, **kwargs) -> torch.nn.Module:
    """Construct a registered model in eval mode on ``device``, its 4-D
    weights in ``torch.channels_last`` (the layout the stem kernel's NHWC
    output feeds). ``kwargs`` go to the model: widths, ``dtype`` (the
    compute dtype; parameters stay f32) and, for the 3-task translator,
    ``quant`` and ``fuse_stems``; the EgoT2-g prompt models take
    ``vocab_size``; the PNR/OSCC models ``arch``, ``crop_size``,
    ``nonlocal_cfg`` (``nn/resnet3d.py::resolve_nonlocal``); the HOI
    translators (``translate/egot2s_hoi.py``) ``target``,
    ``feature_dim``, ``num_layers``, ``alpha``, ``pnr_frames`` and
    ``action_frames``. Weights are the module defaults: load real ones with
    :func:`egot2x_torch.core.bridge.load_jax_variables` or
    ``load_state_dict``; a ``quant`` model then needs
    :func:`egot2x_torch.nn.quant.calibrate` (or calibrated scales in what
    it loads) before int8 inference, and raises without them."""
    register_models()
    return place(MODEL_REGISTRY.get(name)(**kwargs), device)


def register_models() -> None:
    """Import every module that registers a model."""
    import egot2x_torch.models.ar_lta  # noqa: F401
    import egot2x_torch.models.asd  # noqa: F401
    import egot2x_torch.models.lam  # noqa: F401
    import egot2x_torch.models.pnr  # noqa: F401
    import egot2x_torch.models.ttm  # noqa: F401
    import egot2x_torch.translate.egot2g  # noqa: F401
    import egot2x_torch.translate.egot2s_hhi  # noqa: F401
    import egot2x_torch.translate.egot2s_hoi  # noqa: F401


def place(model: torch.nn.Module, device=None) -> torch.nn.Module:
    """``model`` on ``device`` (:func:`resolve_device`), its 4-D weights in
    ``torch.channels_last`` and the 3D trunks' (``channels_last`` convs,
    ``nn/resnet3d.py``) in ``torch.channels_last_3d``, in eval mode."""
    model = model.to(resolve_device(device))
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(memory_format=torch.channels_last)
        elif getattr(m, "channels_last", False):
            m.to(memory_format=torch.channels_last_3d)
    return model.eval()
