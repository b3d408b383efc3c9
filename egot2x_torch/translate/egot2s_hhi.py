"""EgoT2-s HHI translators: cross-task token fusion over frozen backbones.

Counterpart of ``egot2x/translate/egot2s_hhi.py``:

  * ``TaskFusionMFTransformer3Task`` (the flagship): the LAM and TTM
    ResNet-18 per-frame tokens and the TalkNet per-frame AV features, each
    projected 256 -> D, then a shared LayerNorm + a learned task embedding
    + sinusoidal PE restarting per stream, concatenated in the order ttm,
    lam, asd, a post-LN TransformerEncoder, the token mean, LN + Linear->2.
  * ``TaskFusionMFTransformer2Task``: the same without the TalkNet stream.
  * ``TaskFusionMFTransformer3TaskASD``, ASD as the target: the same
    fusion with the asd stream first (its task id stays 2) and no head;
    it returns the first T_asd encoder tokens as per-frame features
    (B*T, D) for the lossAV head (``tasks/asd_2loader.py``).
  * ASD baselines ``FinetuneASD``, ``LAM2ASD`` and ``TTM2ASD``: one frozen
    backbone's per-frame features through ``fc1`` 256 -> D and a ReLU,
    (B*T, D).

Task ids are fixed per stream (ttm 0, lam 1, asd 2). Parameter names are
the reference torch model's (``lam_model.base_model``,
``ttm_model.video_encoder``, ``asd_model``, ``proj_*``, ``task_embed``,
``ln``, ``transformer_encoder.layers.{i}``, ``linear_head.{0,1}``), so
published ``egot2s_*`` checkpoints load as they are (``strict=False``:
they also hold the unused Stage-I BiLSTMs).

``dtype`` is the compute dtype of the float parts (``nn.layers``);
parameters stay f32. The 3-task translator takes ``quant=True`` for the
int8 static-PTQ trunks (``nn.quant``; calibrate first) and, with it,
``fuse_stems=True`` to run the LAM and TTM stems as one int8 launch
(``nn.fused_stem``). The fused stem applies only under int8 inference,
not while calibrating or training; parameters keep the two-trunk layout
either way.

Training (Stage II) freezes the backbones, the keys ``FROZEN_KEYS``: they
run in eval mode whatever ``train()`` says, and under ``torch.no_grad``,
the counterpart of the JAX package's ``stop_gradient``; only the fusion
core learns. ``dropout`` is the encoder's rate; the PE's is 0.1 whatever
it is, as in the JAX package. ``nofreeze`` (train the trunks too) and
``remat`` (recompute their activations in the backward) need backward
passes through the stem kernels and raise until those are ported
(ROADMAP.md §1 item 2).
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.models.lam import LAMBackbone
from egot2x_torch.models.ttm import TTMBackbone
from egot2x_torch.nn.common import (PositionalEncoding, TransformerEncoder,
                                    layer_norm)
from egot2x_torch.nn.fused_stem import fused_rgb_stem
from egot2x_torch.nn.layers import Linear
from egot2x_torch.nn.quant import assert_calibrated, scale_buffers
from egot2x_torch.nn.resnet2d import normalize_u8_frames
from egot2x_torch.nn.talknet import FrozenTalkNet

TASK_IDS = {"ttm": 0, "lam": 1, "asd": 2}
# top-level modules the task layer freezes
FROZEN_KEYS = ("lam_model", "ttm_model", "asd_model")


def _frozen_trunks_only(nofreeze: bool, remat: bool) -> None:
    if nofreeze or remat:
        raise NotImplementedError(
            "nofreeze and remat differentiate the trunks, which needs "
            "backward passes through the stem kernels: not ported yet "
            "(ROADMAP.md §1 item 2)")


def _encode_prepare(x, ln, task_embed, task_id, pos_embed):
    """LN + task embedding + per-stream PE (reference encode_prepare)."""
    return pos_embed(ln(x) + task_embed[:, task_id, :].to(x.dtype))


class _MFTransformerCore(nn.Module):
    """Projection + task embedding + PE + encoder + head, shared by the MF
    translators. ``streams`` names the token streams in concat order."""

    def __init__(self, streams, hidden_dim: int, num_heads: int,
                 num_layers: int, dtype=torch.float32, head: bool = True,
                 dropout: float = 0.1):
        super().__init__()
        self.streams = tuple(streams)
        self.compute_dtype = dtype
        for s in self.streams:
            setattr(self, f"proj_{s}", Linear(256, hidden_dim))
        self.task_embed = nn.Parameter(
            torch.randn(1, len(self.streams), hidden_dim))
        self.pos_embed = PositionalEncoding(hidden_dim, max_len=1000,
                                            dropout=0.1)
        self.transformer_encoder = TransformerEncoder(
            num_layers, hidden_dim, num_heads, dim_feedforward=2048,
            dropout=dropout)
        self.ln = layer_norm(hidden_dim)
        if head:
            self.linear_head = nn.Sequential(layer_norm(hidden_dim),
                                             Linear(hidden_dim, 2))

    def encode(self, tokens):
        """tokens: {stream: (B, T_s, 256)} -> encoder output
        (B, sum T_s, D) in stream order, in the compute dtype."""
        prepared = [
            _encode_prepare(getattr(self, f"proj_{s}")(tokens[s]), self.ln,
                            self.task_embed, TASK_IDS[s], self.pos_embed)
            for s in self.streams]
        return self.transformer_encoder(torch.cat(prepared, dim=1))

    def fuse(self, tokens):
        """tokens: {stream: (B, T_s, 256)} -> logits (B, 2), in the
        compute dtype."""
        return self.linear_head(self.encode(tokens).mean(dim=1))


@MODEL_REGISTRY.register(name="TaskFusionMFTransformer2Task")
class TaskFusionMFTransformer2Task(_MFTransformerCore):
    """LAM + TTM token fusion -> TTM logits."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 3, dtype=torch.float32,
                 dropout: float = 0.1, nofreeze: bool = False,
                 remat: bool = False):
        _frozen_trunks_only(nofreeze, remat)
        super().__init__(("ttm", "lam"), hidden_dim, num_heads, num_layers,
                         dtype, dropout=dropout)
        self.lam_model = LAMBackbone(dtype=dtype)
        self.ttm_model = TTMBackbone(dtype=dtype)

    def forward(self, video, audio=None):
        """video (B, T, H, W, 3), f32 normalized or uint8."""
        with torch.no_grad():   # the frozen trunks
            video = normalize_u8_frames(video, self.compute_dtype)  # once
            tokens = {"ttm": self.ttm_model(video, audio),
                      "lam": self.lam_model(video)}
        return self.fuse(tokens)


@MODEL_REGISTRY.register(name="TaskFusionMFTransformer3Task")
class TaskFusionMFTransformer3Task(_MFTransformerCore):
    """LAM + TTM + ASD token fusion -> TTM logits (the flagship)."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 3, quant: bool = False,
                 fuse_stems: bool = False, dtype=torch.float32,
                 dropout: float = 0.1, nofreeze: bool = False,
                 remat: bool = False):
        _frozen_trunks_only(nofreeze, remat)
        super().__init__(("ttm", "lam", "asd"), hidden_dim, num_heads,
                         num_layers, dtype, dropout=dropout)
        self.lam_model = LAMBackbone(quant=quant, dtype=dtype)
        self.ttm_model = TTMBackbone(quant=quant, dtype=dtype)
        self.asd_model = FrozenTalkNet(quant, dtype)
        self.quant, self.fuse_stems = quant, fuse_stems
        self.calibrating = False
        self._checked_scales = None

    def forward(self, video, video_asd, audio, audio_asd):
        """video (B, T, H, W, 3) RGB, f32 normalized or uint8; video_asd
        (B, T, 112, 112) grey in [0, 255], float or uint8; audio (B, S)
        raw wave (unused on this path); audio_asd (B, 4T, 13) MFCC."""
        int8 = self.quant and not self.calibrating
        if int8:
            self._assert_calibrated()
        with torch.no_grad():   # the frozen trunks
            video = normalize_u8_frames(video, self.compute_dtype)  # once
            asd, _, _ = self.asd_model(audio_asd, video_asd)
            stem_lam = stem_ttm = None
            if int8 and self.fuse_stems and not self.training:
                n, t = video.shape[:2]
                stem_lam, stem_ttm = fused_rgb_stem(
                    video.reshape(n * t, *video.shape[2:]),
                    [self.lam_model.base_model, self.ttm_model.video_encoder])
            tokens = {"ttm": self.ttm_model(video, audio, stem_ttm),
                      "lam": self.lam_model(video, stem_lam), "asd": asd}
        return self.fuse(tokens)

    def _assert_calibrated(self):
        """``assert_calibrated`` once for each state of the scales: the
        check reads every scale on the host, so it reruns only after a
        scale was written or moved."""
        bufs = [b for _, b in scale_buffers(self)]
        key = [(b.data_ptr(), b._version) for b in bufs]
        if key != self._checked_scales:
            assert_calibrated(self)
            self._checked_scales = key


@MODEL_REGISTRY.register(name="TaskFusionMFTransformer3TaskASD")
class TaskFusionMFTransformer3TaskASD(_MFTransformerCore):
    """LAM + TTM + ASD token fusion -> per-frame ASD features (B*T, D):
    the asd stream goes first, and its T_asd encoder tokens are the
    output. The reference's serialized ``linear_head`` is dead on this
    path and not built (load its checkpoints with ``strict=False``)."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 3, dtype=torch.float32):
        super().__init__(("asd", "ttm", "lam"), hidden_dim, num_heads,
                         num_layers, dtype, head=False)
        self.lam_model = LAMBackbone(dtype=dtype)
        self.ttm_model = TTMBackbone(dtype=dtype)
        self.asd_model = FrozenTalkNet(dtype=dtype)
        self.output_dim = hidden_dim

    def forward(self, video, video_asd, audio, audio_asd):
        """Inputs as the 3-task translator's."""
        with torch.no_grad():   # the frozen trunks
            video = normalize_u8_frames(video, self.compute_dtype)  # once
            asd, _, _ = self.asd_model(audio_asd, video_asd)
            tokens = {"asd": asd, "ttm": self.ttm_model(video, audio),
                      "lam": self.lam_model(video)}
        out = self.encode(tokens)
        n, t = asd.shape[:2]
        return out[:, :t].reshape(n * t, self.output_dim)


class _FrameBaseline(nn.Module):
    """One frozen backbone's per-frame features -> ``fc1`` 256 -> D, ReLU
    -> (B*T, D). The fusion widths (``num_heads``, ``num_layers``) are
    taken and unused, as in the JAX package, so any ASD translator builds
    from one set of arguments."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 3, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.output_dim = hidden_dim
        self.fc1 = Linear(256, hidden_dim)

    def features(self, video, video_asd, audio, audio_asd):
        raise NotImplementedError

    def forward(self, video, video_asd, audio, audio_asd):
        with torch.no_grad():   # the frozen backbone
            feats = self.features(video, video_asd, audio, audio_asd)
        n, t = feats.shape[:2]
        return torch.relu(self.fc1(feats)).reshape(n * t, self.output_dim)


@MODEL_REGISTRY.register(name="FinetuneASD")
class FinetuneASD(_FrameBaseline):
    """Frozen TalkNet's AV features."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.asd_model = FrozenTalkNet(dtype=self.compute_dtype)

    def features(self, video, video_asd, audio, audio_asd):
        return self.asd_model(audio_asd, video_asd)[0]


@MODEL_REGISTRY.register(name="LAM2ASD")
class LAM2ASD(_FrameBaseline):
    """Frozen LAM trunk's per-frame tokens."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.lam_model = LAMBackbone(dtype=self.compute_dtype)

    def features(self, video, video_asd, audio, audio_asd):
        return self.lam_model(normalize_u8_frames(video, self.compute_dtype))


@MODEL_REGISTRY.register(name="TTM2ASD")
class TTM2ASD(_FrameBaseline):
    """Frozen TTM video trunk's per-frame tokens."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ttm_model = TTMBackbone(dtype=self.compute_dtype)

    def features(self, video, video_asd, audio, audio_asd):
        return self.ttm_model(normalize_u8_frames(video, self.compute_dtype),
                              audio)
