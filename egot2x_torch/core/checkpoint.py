"""Checkpoints in the port's own format, and Stage-I -> Stage-II grafting.

Counterpart of ``egot2x/core/checkpoint.py``. A checkpoint is one
``torch.save`` file of a train state's ``state_dict`` (``step``, the whole
model's ``state_dict`` with its frozen trunks, BN statistics and int8
scales, and the optimizer's); the Trainer's checkpoint directory holds
``epoch_{N}.pt``, ``epoch_{N}.metrics.json`` and ``last.json``, which
names the last epoch saved. A model goes to the JAX package's variable
tree through :func:`egot2x_torch.core.bridge.to_jax_variables`.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
from torch import nn


def epoch_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"epoch_{epoch}.pt")


def last_epoch(directory: str) -> int:
    with open(os.path.join(directory, "last.json")) as f:
        return int(json.load(f)["epoch"])


def latest_checkpoint(path: str) -> str:
    """A checkpoint file as it is, or the last epoch's file of a Trainer
    checkpoint directory."""
    if os.path.isfile(path):
        return path
    return epoch_path(path, last_epoch(path))


def load_checkpoint(path: str) -> dict:
    """The state dict saved at ``path`` (a file or a Trainer directory),
    on the CPU."""
    return torch.load(latest_checkpoint(path), map_location="cpu",
                      weights_only=True)


def graft_backbone(model: nn.Module, backbone_key: str, stage1_ckpt: str,
                   params_src: Optional[str] = None) -> nn.Module:
    """Load a Stage-I checkpoint's weights and statistics into the
    backbone ``model.<backbone_key>`` in place. ``params_src``: the
    submodule of the Stage-I model that is the backbone (``"model"`` for
    ``TalkNetWithHeads``), or None when the backbone's own names sit at
    the top of the Stage-I model (a LAM or TTM model's ``base_model`` /
    ``video_encoder``). Every key of the backbone must be in it."""
    state = load_checkpoint(stage1_ckpt)["model"]
    if params_src is not None:
        prefix = params_src + "."
        state = {k[len(prefix):]: v for k, v in state.items()
                 if k.startswith(prefix)}
    target = getattr(model, backbone_key)
    want = target.state_dict()
    missing = sorted(k for k in want if k not in state)
    if missing:
        raise KeyError(f"{stage1_ckpt} has no {backbone_key} weights for "
                       f"{missing[:3]} ({len(missing)} keys)")
    target.load_state_dict({k: state[k] for k in want})
    return model


# (backbone, config key of its Stage-I checkpoint, the backbone's
# submodule in the Stage-I model: TalkNetWithHeads holds TalkNet as
# ``model``; a LAM or TTM model's trunk names sit at its top)
GRAFTS = (("lam_model", "lam_checkpoint", None),
          ("ttm_model", "ttm_checkpoint", None),
          ("asd_model", "asd_checkpoint", "model"))


def graft_stage1(translator: nn.Module, cfg) -> nn.Module:
    """The Stage-I checkpoints ``cfg`` names (``GRAFTS``), grafted into
    those of the translator's backbones it has."""
    for key, flag, src in GRAFTS:
        if cfg.get(flag) and hasattr(translator, key):
            graft_backbone(translator, key, cfg.get(flag), params_src=src)
    return translator
