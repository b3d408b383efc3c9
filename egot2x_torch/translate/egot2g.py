"""EgoT2-g HHI: the task-general prompt translators.

Counterpart of the HHI half of ``egot2x/translate/egot2g.py``. Frozen
LAM and TTM ResNet-18 trunks and TalkNet give per-frame tokens (B, T,
256); each stream goes through its ``proj_*`` 256 -> D, the shared
LayerNorm ``ln``, its row of the task embedding and a sinusoidal PE that
restarts for each stream, then a post-LN encoder. A causal post-LN
decoder reads the label tokens (the vocabulary of ``translate/vocab.py``,
embedded and scaled by sqrt(D), the same PE) against the encoder's output,
and ``fc`` gives logits over the vocabulary.

  * ``TaskTranslationPromptTransformer`` (EgoT2-g): for ``ttm`` and
    ``asd`` the three streams in the order lam, ttm, asd (task-embed rows
    0, 1, 2) are encoded together; ``lam`` encodes the LAM stream alone
    and runs no other trunk. For ``asd`` every frame becomes a decode
    batch element whose memory is its three encoded tokens, (B*T, 3, D).
  * ``TaskPromptTransformer`` (the Unified3Task baseline): each task
    encodes its own stream only; ``asd`` decodes each frame against its
    one token, (B*T, 1, D).

Entry points: ``forward(video, video_asd, audio, audio_asd, target,
task)`` decodes ``target`` (B', S) teacher-forced into logits (B', S, V);
``predict(video, video_asd, audio, audio_asd, task)`` decodes one greedy
step from the task's token (``TASK_IDS``) and returns the logits of the
last two ids, '0' and '1', (B', 2). ``encode`` and ``first_token_logits``
are the two halves of ``predict``, so that a caller can decode one
encoding both ways. ``video`` is (B, T, H, W, 3) RGB, f32 normalized or
uint8; ``video_asd`` (B, T, 112, 112) grey faces in [0, 255]; ``audio``
the raw wave (unused: the TTM trunk is its video half); ``audio_asd``
(B, 4T, 13) MFCC.

Parameter names are the reference torch model's (``lam_model.base_model``,
``ttm_model.video_encoder``, ``asd_model``, ``proj_*``, ``task_embed``,
``ln``, ``embedding``, ``fc``, ``transformer_encoder.layers.{i}``,
``transformer_decoder.layers.{i}``), so its checkpoints load as they are
(``strict=False``: they also hold the unused Stage-I BiLSTMs); the JAX
package holds the prompt core under ``core/``. The backbones
(``FROZEN_KEYS``) run in eval mode under ``no_grad`` always, as the JAX
package ``stop_gradient``s them; ``dropout`` is the encoder's and the
decoder's rate, the PE's is 0.1 whatever it is, as in the JAX package.
Everything computes in f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.models.lam import LAMBackbone
from egot2x_torch.models.ttm import TTMBackbone
from egot2x_torch.nn.common import (PositionalEncoding, TransformerDecoder,
                                    TransformerEncoder, layer_norm)
from egot2x_torch.nn.layers import Linear
from egot2x_torch.nn.resnet2d import normalize_u8_frames
from egot2x_torch.nn.talknet import FrozenTalkNet

# the backbones, frozen
FROZEN_KEYS = ("lam_model", "ttm_model", "asd_model")
# task-embedding row of each stream
STREAM_IDS = {"lam": 0, "ttm": 1, "asd": 2}


class _HHIPromptBase(nn.Module):
    """The backbones, the stream projections and the prompt core."""

    # each task's token in the HHI vocabulary, the decode's first token
    TASK_IDS = {"lam": 3, "ttm": 2, "asd": 4}

    def __init__(self, vocab_size: int, hidden_dim: int = 256,
                 num_heads: int = 4, num_layers: int = 3,
                 dropout: float = 0.1):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.transformer_encoder = TransformerEncoder(
            num_layers, hidden_dim, num_heads, dim_feedforward=2048,
            dropout=dropout)
        self.transformer_decoder = TransformerDecoder(
            num_layers, hidden_dim, num_heads, dim_feedforward=2048,
            dropout=dropout)
        self.ln = layer_norm(hidden_dim)
        self.task_embed = nn.Parameter(torch.randn(1, 3, hidden_dim))
        self.pos_embed = PositionalEncoding(hidden_dim, dropout=0.1)
        self.embedding = nn.Embedding(vocab_size, hidden_dim)
        self.fc = Linear(hidden_dim, vocab_size)
        for s in STREAM_IDS:
            setattr(self, f"proj_{s}", Linear(256, hidden_dim))
        self.lam_model = LAMBackbone()
        self.ttm_model = TTMBackbone()
        self.asd_model = FrozenTalkNet()

    # -- the streams: frozen backbones -> prepared tokens (B, T, D) --------
    def _stream(self, name, video, video_asd, audio, audio_asd):
        with torch.no_grad():
            if name == "lam":
                tokens = self.lam_model(video)
            elif name == "ttm":
                tokens = self.ttm_model(video, audio)
            else:
                tokens = self.asd_model(audio_asd, video_asd)[0]
        x = self.ln(getattr(self, f"proj_{name}")(tokens))
        return self.pos_embed(x + self.task_embed[:, STREAM_IDS[name]])

    def _streams(self, names, video, video_asd, audio, audio_asd):
        video = normalize_u8_frames(video, torch.float32)
        return [self._stream(n, video, video_asd, audio, audio_asd)
                for n in names]

    # -- the decoder -------------------------------------------------------
    def decode(self, target, encoded):
        """target (B', S) token ids, encoded (B', M, D) -> logits
        (B', S, V)."""
        emb = self.embedding(target) * math.sqrt(self.hidden_dim)
        out = self.transformer_decoder(self.pos_embed(emb), encoded,
                                       is_causal=True)
        return self.fc(out)

    def first_token_logits(self, encoded, task: str):
        """One greedy step from the task's token: the logits of '0' and
        '1', (B', 2)."""
        bos = torch.full((encoded.shape[0], 1), self.TASK_IDS[task],
                         dtype=torch.long, device=encoded.device)
        return self.decode(bos, encoded)[:, 0, -2:]

    def forward(self, video, video_asd, audio, audio_asd, target, task: str):
        """Teacher-forced: target (B', S) -> logits (B', S, V)."""
        return self.decode(target, self.encode(video, video_asd, audio,
                                               audio_asd, task))

    @torch.no_grad()
    def predict(self, video, video_asd, audio, audio_asd, task: str):
        """Greedy 1-step: logits over the last two vocab ids, (B', 2)."""
        return self.first_token_logits(
            self.encode(video, video_asd, audio, audio_asd, task), task)


@MODEL_REGISTRY.register(name="TaskTranslationPromptTransformer")
class TaskTranslationPromptTransformer(_HHIPromptBase):
    """HHI EgoT2-g: cross-task 3-stream encoding for ttm and asd."""

    def encode(self, video, video_asd, audio, audio_asd, task: str):
        """-> encoder memory: (B, T, D) for lam, (B, 3T, D) for ttm,
        (B*T, 3, D) for asd."""
        names = ("lam",) if task == "lam" else tuple(STREAM_IDS)
        encoded = self.transformer_encoder(torch.cat(
            self._streams(names, video, video_asd, audio, audio_asd), dim=1))
        if task == "asd":
            # frame i of each stream: (B, 3, T, D) -> (B*T, 3, D)
            b, three_t, d = encoded.shape
            encoded = encoded.reshape(b, 3, three_t // 3, d).transpose(1, 2)
            encoded = encoded.reshape(-1, 3, d)
        return encoded


@MODEL_REGISTRY.register(name="TaskPromptTransformer")
class TaskPromptTransformer(_HHIPromptBase):
    """HHI baseline: each task encodes its own stream only."""

    def encode(self, video, video_asd, audio, audio_asd, task: str):
        """-> encoder memory: (B, T, D) for lam and ttm, (B*T, 1, D) for
        asd."""
        encoded = self.transformer_encoder(
            self._streams((task,), video, video_asd, audio, audio_asd)[0])
        if task == "asd":
            encoded = encoded.reshape(-1, 1, encoded.shape[-1])
        return encoded
