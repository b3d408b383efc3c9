"""ASD 2-loader task, inference: EgoT2-s translators with ASD as target.

Counterpart of ``egot2x/tasks/asd_2loader.py`` without its training half.
A batch holds both the ASD streams (grey faces + MFCC) and the TTM-style
streams (RGB frames + raw wave) of the same tracks; the model is an ASD
translator returning per-frame features (B*T, D) and the reference's
``lossAV`` linear head on them (egot2x's ``_LossAVHead``); validation is
frame accuracy from that head, as in Stage I.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

import egot2x_torch.translate.egot2s_hhi  # noqa: F401  (registers)
from egot2x_torch.core.registry import MODEL_REGISTRY, place
from egot2x_torch.models.asd import LossHead
from egot2x_torch.tasks.asd import ActiveSpeakerDetection


class _TranslatorWithHead(nn.Module):
    """An ASD translator (per-frame features) + the lossAV head, at the
    JAX package's Stage-II defaults: hidden 128, 1 layer, 4 heads."""

    def __init__(self, model_name: str = "TaskFusionMFTransformer3TaskASD",
                 hidden_dim: int = 128, num_layers: int = 1,
                 num_heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.translator = MODEL_REGISTRY.get(model_name)(
            hidden_dim=hidden_dim, num_heads=num_heads,
            num_layers=num_layers, dtype=dtype)
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


class ActiveSpeakerDetection2Loader(ActiveSpeakerDetection):
    """Frame-accuracy validation of a ``_TranslatorWithHead``, whose
    batches hold ``frames`` (B, T, H, W, 3), ``faces``, ``audio`` (raw
    wave, unused by the translators' frozen trunks), ``mfcc``, ``labels``
    and optionally ``valid``."""

    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            logits = self.model(batch["frames"], batch["faces"],
                                batch["audio"], batch["mfcc"])
        b = batch["labels"].shape[0]
        labels = batch["labels"].reshape(-1)[:logits.shape[0]]
        correct = (logits.argmax(-1) == labels).to(torch.int32)
        return {"correct": correct.reshape(b, -1).sum(dim=1),
                "total": torch.full((b,), correct.shape[0] // b,
                                    dtype=torch.int32,
                                    device=correct.device),
                "scores": torch.softmax(logits, dim=-1)[:, 1]}
