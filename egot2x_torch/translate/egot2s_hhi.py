"""EgoT2-s HHI translators: cross-task token fusion over frozen backbones.

Counterpart of ``egot2x/translate/egot2s_hhi.py``, float inference:

  * ``TaskFusionMFTransformer3Task`` (the flagship): the LAM and TTM
    ResNet-18 per-frame tokens and the TalkNet per-frame AV features, each
    projected 256 -> D, then a shared LayerNorm + a learned task embedding
    + sinusoidal PE restarting per stream, concatenated in the order ttm,
    lam, asd, a post-LN TransformerEncoder, the token mean, LN + Linear->2.
  * ``TaskFusionMFTransformer2Task``: the same without the TalkNet stream.

Task ids are fixed per stream (ttm 0, lam 1, asd 2). Parameter names are
the reference torch model's (``lam_model.base_model``,
``ttm_model.video_encoder``, ``asd_model``, ``proj_*``, ``task_embed``,
``ln``, ``transformer_encoder.layers.{i}``, ``linear_head.{0,1}``), so
published ``egot2s_*`` checkpoints load as they are (``strict=False``:
they also hold the unused Stage-I BiLSTMs).
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.models.lam import LAMBackbone
from egot2x_torch.models.ttm import TTMBackbone
from egot2x_torch.nn.common import (PositionalEncoding, TransformerEncoder,
                                    layer_norm)
from egot2x_torch.nn.resnet2d import normalize_u8_frames
from egot2x_torch.nn.talknet import TalkNetModel

TASK_IDS = {"ttm": 0, "lam": 1, "asd": 2}


def _encode_prepare(x, ln, task_embed, task_id, pos_embed):
    """LN + task embedding + per-stream PE (reference encode_prepare)."""
    return pos_embed(ln(x) + task_embed[:, task_id, :])


class _MFTransformerCore(nn.Module):
    """Projection + task embedding + PE + encoder + head, shared by the MF
    translators. ``streams`` names the token streams in concat order."""

    def __init__(self, streams, hidden_dim: int, num_heads: int,
                 num_layers: int):
        super().__init__()
        self.streams = tuple(streams)
        for s in self.streams:
            setattr(self, f"proj_{s}", nn.Linear(256, hidden_dim))
        self.task_embed = nn.Parameter(
            torch.randn(1, len(self.streams), hidden_dim))
        self.pos_embed = PositionalEncoding(hidden_dim, max_len=1000)
        self.transformer_encoder = TransformerEncoder(
            num_layers, hidden_dim, num_heads, dim_feedforward=2048)
        self.ln = layer_norm(hidden_dim)
        self.linear_head = nn.Sequential(layer_norm(hidden_dim),
                                         nn.Linear(hidden_dim, 2))

    def fuse(self, tokens):
        """tokens: {stream: (B, T_s, 256)} -> logits (B, 2)."""
        prepared = [
            _encode_prepare(getattr(self, f"proj_{s}")(tokens[s]), self.ln,
                            self.task_embed, TASK_IDS[s], self.pos_embed)
            for s in self.streams]
        out = self.transformer_encoder(torch.cat(prepared, dim=1))
        return self.linear_head(out.mean(dim=1))


@MODEL_REGISTRY.register(name="TaskFusionMFTransformer2Task")
class TaskFusionMFTransformer2Task(_MFTransformerCore):
    """LAM + TTM token fusion -> TTM logits."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 3):
        super().__init__(("ttm", "lam"), hidden_dim, num_heads, num_layers)
        self.lam_model = LAMBackbone()
        self.ttm_model = TTMBackbone()

    def forward(self, video, audio=None):
        """video (B, T, H, W, 3), f32 normalized or uint8."""
        video = normalize_u8_frames(video)  # once, for both trunks
        return self.fuse({"ttm": self.ttm_model(video, audio),
                          "lam": self.lam_model(video)})


@MODEL_REGISTRY.register(name="TaskFusionMFTransformer3Task")
class TaskFusionMFTransformer3Task(_MFTransformerCore):
    """LAM + TTM + ASD token fusion -> TTM logits (the flagship)."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 3):
        super().__init__(("ttm", "lam", "asd"), hidden_dim, num_heads,
                         num_layers)
        self.lam_model = LAMBackbone()
        self.ttm_model = TTMBackbone()
        self.asd_model = TalkNetModel()

    def forward(self, video, video_asd, audio, audio_asd):
        """video (B, T, H, W, 3) RGB, f32 normalized or uint8; video_asd
        (B, T, 112, 112) grey in [0, 255], float or uint8; audio (B, S)
        raw wave (unused on this path); audio_asd (B, 4T, 13) MFCC."""
        video = normalize_u8_frames(video)  # once, for both trunks
        asd, _, _ = self.asd_model(audio_asd, video_asd)
        return self.fuse({"ttm": self.ttm_model(video, audio),
                          "lam": self.lam_model(video), "asd": asd})
