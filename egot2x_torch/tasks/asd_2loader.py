"""ASD 2-loader task: EgoT2-s translators with ASD as target, Stage II.

Counterpart of ``egot2x/tasks/asd_2loader.py``. A batch holds both the
ASD streams (grey faces + MFCC) and the TTM-style streams (RGB frames +
raw wave) of the same tracks: ``frames`` (B, T, H, W, 3), ``faces``
(B, T, H, W), ``audio`` (B, S; unused by the translators' trunks),
``mfcc`` (B, 4T, 13), ``labels`` (B, T) and optionally ``valid`` (B,).
The model is an ASD translator returning per-frame features (B*T, D) and
the reference's ``lossAV`` linear head on them (egot2x's ``_LossAVHead``);
the loss is the per-frame weighted CE with ``ASD_CLASS_WEIGHTS`` over the
B*T frames, validation is frame accuracy from the same head, as in
Stage I. Its loaders bucket the trials of ``data/asd.py`` with the RGB
stream (``rgb_size``, 224).

``build_state`` draws the weights from a seed (the weight bridge's seeded
tree), grafts the Stage-I checkpoints the config names into the
translator's backbones and hands Adam the translator's parameters less
its frozen backbones (``FROZEN_KEYS``), or all of them with ``nofreeze``
(the backbones still run in eval mode). The model runs on the card unless
``device`` says otherwise.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

import egot2x_torch.translate.egot2s_hhi  # noqa: F401  (registers)
from egot2x_torch.core.checkpoint import graft_stage1
from egot2x_torch.core.registry import MODEL_REGISTRY, place
from egot2x_torch.models.asd import LossHead
from egot2x_torch.nn.common import set_dropout_generator
from egot2x_torch.data.asd import AsdTrialDataset
from egot2x_torch.tasks.asd import (ASD_CLASS_WEIGHTS, FrameAccuracy,
                                    TrialLoaders)
from egot2x_torch.tasks.base import (Task, resolve_dtype,
                                     weighted_cross_entropy)
from egot2x_torch.train.optim import construct_optimizer
from egot2x_torch.train.state import TrainState, split_params
from egot2x_torch.translate.egot2s_hhi import FROZEN_KEYS


class _TranslatorWithHead(nn.Module):
    """An ASD translator (per-frame features) + the lossAV head, at the
    JAX package's Stage-II defaults: hidden 128, 1 layer, 4 heads, dropout
    0.1. ``nofreeze`` and ``remat`` go to the translator."""

    def __init__(self, model_name: str = "TaskFusionMFTransformer3TaskASD",
                 hidden_dim: int = 128, num_layers: int = 1,
                 num_heads: int = 4, dtype=torch.float32,
                 dropout: float = 0.1, nofreeze: bool = False,
                 remat: bool = False):
        super().__init__()
        self.translator = MODEL_REGISTRY.get(model_name)(
            hidden_dim=hidden_dim, num_heads=num_heads,
            num_layers=num_layers, dtype=dtype, dropout=dropout,
            nofreeze=nofreeze, remat=remat)
        self.lossAV = LossHead(self.translator.output_dim)

    def forward(self, video, video_asd, audio, audio_asd):
        """Inputs as the 3-task translator's -> logits (B*T, 2)."""
        return self.lossAV(self.translator(video, video_asd, audio,
                                           audio_asd))


def build_translator_with_head(model_name: str = (
        "TaskFusionMFTransformer3TaskASD"), device=None,
        **kwargs) -> _TranslatorWithHead:
    """``_TranslatorWithHead`` placed as ``build_model`` places a model:
    on the card unless ``device`` says otherwise, in eval mode."""
    return place(_TranslatorWithHead(model_name, **kwargs), device)


class ActiveSpeakerDetection2Loader(FrameAccuracy, TrialLoaders, Task):
    """Stage-II training and frame-accuracy validation of an ASD
    translator behind the lossAV head, from ``cfg``: ``model`` (default
    ``TaskFusionMFTransformer3TaskASD``), ``hidden_dim`` (128),
    ``num_layers`` (1), ``num_heads`` (4), ``dropout`` (0.1),
    ``nofreeze``, ``remat``, ``compute_dtype``, ``lr`` and the Stage-I
    checkpoints (``lam_checkpoint``, ``ttm_checkpoint``,
    ``asd_checkpoint``)."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.model = build_translator_with_head(
            cfg.get("model", "TaskFusionMFTransformer3TaskASD"),
            device=device, hidden_dim=cfg.get("hidden_dim", 128),
            num_layers=cfg.get("num_layers", 1),
            num_heads=cfg.get("num_heads", 4), dtype=resolve_dtype(cfg),
            dropout=cfg.get("dropout", 0.1),
            nofreeze=cfg.get("nofreeze", False),
            remat=cfg.get("remat", False))
        self.device = next(self.model.parameters()).device
        self.class_weights = torch.from_numpy(ASD_CLASS_WEIGHTS).to(
            self.device)

    def _dataset(self, split):
        return AsdTrialDataset(self.cfg.data_root, split=split,
                               with_rgb=True,
                               rgb_size=self.cfg.get("rgb_size", 224),
                               device=self.device)

    def build_state(self, seed: int = 0) -> TrainState:
        """Weights drawn from ``seed``, the configured Stage-I backbones
        grafted over them, the backbones frozen unless ``nofreeze``, and
        Adam (no weight decay, as the JAX task's ``optax.adam``) over the
        rest."""
        from egot2x_torch.core import bridge   # it imports this module

        c, model = self.cfg, self.model
        bridge.load_jax_variables(model,
                                  bridge.random_jax_variables(model, seed))
        graft_stage1(model.translator, c)
        frozen_keys = () if c.get("nofreeze") else FROZEN_KEYS
        trainable, _ = split_params(model.translator,
                                    lambda k: k in frozen_keys)
        trainable = {f"translator.{n}": p for n, p in trainable.items()}
        trainable.update((f"lossAV.{n}", p)
                         for n, p in model.lossAV.named_parameters())
        return TrainState(model, construct_optimizer(trainable, "adam",
                                                     lr=c.lr))

    def _model_inputs(self, batch):
        return (batch["frames"], batch["faces"], batch["audio"],
                batch["mfcc"])

    def train_step(self, state, batch, generator):
        """One Adam step on the per-frame weighted CE of a train-mode
        forward whose dropout masks ``generator`` draws, computed in f32;
        metrics ``loss`` and frame accuracy ``acc``."""
        model = set_dropout_generator(state.model.train(), generator)
        logits = model(*self._model_inputs(batch))
        labels = batch["labels"].reshape(-1)[:logits.shape[0]].long()
        loss = weighted_cross_entropy(logits.float(), labels,
                                      self.class_weights)
        state.apply_loss(loss)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return state, {"loss": loss.detach(), "acc": acc}

    def eval_step(self, state, batch) -> Dict[str, torch.Tensor]:
        """Per-track ``correct`` and ``total`` frames (int32) and the
        per-frame speaking ``scores``, from an eval-mode forward."""
        model = state.model.eval()
        with torch.no_grad():
            logits = model(*self._model_inputs(batch))
        b = batch["labels"].shape[0]
        labels = batch["labels"].reshape(-1)[:logits.shape[0]]
        correct = (logits.argmax(-1) == labels).to(torch.int32)
        return {"correct": correct.reshape(b, -1).sum(dim=1),
                "total": torch.full((b,), correct.shape[0] // b,
                                    dtype=torch.int32,
                                    device=correct.device),
                "scores": torch.softmax(logits, dim=-1)[:, 1]}
