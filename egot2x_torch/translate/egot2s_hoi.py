"""EgoT2-s HOI translators with a PNR or OSCC target: inference on the card.

Counterpart of ``egot2x/translate/egot2s_hoi.py``, its shared parts and
its PNR/OSCC-target models (the AR- and LTA-target ones are not ported
yet):

  * ``TaskFusionMFTransformer3TaskDropout``, the ts_pnr / ts_oscc model:
    per-frame tokens of the frozen PNR and OSCC ResNet3D-50s (``proj1``,
    ``proj2``: 8192 -> D at crop 225), the frozen SlowFast's slow tokens
    (its res5 map's spatial mean a frame, ``proj3_slow`` 2048 -> D) and its
    fast ones adaptive-average-pooled to 8 (``proj3_fast`` 256 -> D), each
    stream through the feature dropout, concatenated (16 + 16 + 8 + 8 = 48
    tokens at alpha 4, 44 at alpha 8), then ``core``: one LayerNorm
    ``ln``, the learned ``pe`` (1, L, D), a post-LN encoder (8 heads, FFN
    2 D), the token mean and the same ``ln`` again (``norm_pooled``: the
    reference's head is ``Sequential(self.ln, Linear)``), and ``head_fc``
    -> 16 (``target="keyframe"``) or 2 (``"state"``) logits.
  * ``Keyframe2State``, ``State2Keyframe``, ``FinetuneState``,
    ``FinetuneKeyframe``: one trunk's token mean through ``head``
    (``DupFeatHead``: the mean twice, ``fc1`` 2 x 8192 -> 512, ReLU,
    ``fc2``).
  * ``Action2State``, ``Action2Keyframe``: the frozen SlowFast and its
    frozen ``action_head`` (one ``feature_dim`` output), ReLU, ``fc1``.
  * ``TaskFusionMFTransformer2TaskPnr``: the PNR and OSCC streams (32
    tokens) through ``core`` without ``norm_pooled``, ``head_fc``;
    ``TaskFusionLFLinearPnr``: the two token means joined, ``fc1`` -> 512,
    ReLU, ``fc2``.
  * ``TaskFusionLFLinear3TaskPnr``: the four projected streams (D 512),
    their token mean, ReLU, ``fc1``; ``TaskFusionLFLinear3TaskSimple``: the
    two trunks' token means projected to D and the live ``action_head``'s
    D-d feature of the frozen SlowFast maps, joined, ReLU, ``fc1``;
    ``TaskFusionLFTransformer3TaskDropout``: those three as 3 tokens with
    feature dropout, through ``core`` (``norm_pooled``), ``head_fc``.
  * ``TaskFusionMFTransformer3TaskPnr``: the 48 tokens, ``ln`` + ``pe``,
    the pre-LN ``nn/simple_vit.py`` encoder (``transformer``: D 256, depth
    3, 8 heads of 128, MLP 512), ``ln`` of the token mean, ``head_fc``.

Inputs: ``frames`` (B, T, S, S, 3) raw [0, 255] pixels for the PNR and
OSCC trunks (uint8, only cast, or float), and ``pathways`` ``[slow (B,
T_a / alpha, 224, 224, 3), fast (B, T_a, 224, 224, 3)]`` for SlowFast
(uint8, normalised in its stems, or float taken as it is). The learned
``pe`` fixes the token count when the model is built: ``pnr_frames`` (T)
and ``action_frames`` (T_a) give it.

The trunks are kept under ``HOI_FROZEN_KEYS`` (``pnr_model``,
``oscc_model``, ``action_model``) with the JAX package's names, so the
weight bridge pairs module paths; the PNR and OSCC models' head
projections, which their tokens never reach, are dropped, as the JAX tree
has none. The trunks run in eval mode whatever ``train()`` asks, under
``no_grad`` (the JAX package's ``stop_gradient``); ``action_head`` stays
outside it where the JAX package keeps it live. These are inference only:
the HOI Stage-II training path (and the JAX package's ``nofreeze``) is not
ported.

``dtype`` is the compute dtype (parameters stay f32). Where the JAX package
adds the f32 ``pe`` to a bf16 LayerNorm output, jnp promotes the sum to
f32, and so does torch here: the encoder then computes in the dtype (its
first residual sum in f32), and the simple_vit encoder's residual stream
stays f32 under bf16 blocks, as in the JAX package. The int8 trunks are not
ported: ``quant=True`` raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.models.ar_lta import head_dim
from egot2x_torch.models.pnr import (TRUNK_CHANNELS,
                                     KeyframeLocalizationResNet,
                                     StateChangeClsResNet)
from egot2x_torch.nn.common import Dropout, TransformerEncoder, layer_norm
from egot2x_torch.nn.layers import Linear
from egot2x_torch.nn.resnet3d import QUANT_NOT_PORTED
from egot2x_torch.nn.simple_vit import SimpleViTEncoder
from egot2x_torch.nn.slowfast import MultiTaskHead, SlowFast

HOI_FROZEN_KEYS = ("pnr_model", "oscc_model", "action_model", "lta_model")
FAST_TOKENS = 8   # the fast pathway's tokens after the adaptive pool
# the feature and encoder dropout rates, the JAX defaults: identities in
# eval, and these models are inference only
FEAT_DROPOUT, TRANSFORMER_DROPOUT = 0.5, 0.1


def adaptive_avg_pool_time(x: torch.Tensor, out_t: int) -> torch.Tensor:
    """(B, T, D) -> (B, out_t, D) with torch's AdaptiveAvgPool windows
    [floor(i T / out_t), ceil((i + 1) T / out_t))."""
    return F.adaptive_avg_pool1d(x.transpose(1, 2), out_t).transpose(1, 2)


def _n_out(target: str) -> int:
    if target not in ("keyframe", "state"):
        raise ValueError(f"target {target!r}: 'keyframe' or 'state'")
    return 16 if target == "keyframe" else 2


def _token_trunk(model: nn.Module) -> nn.Module:
    """A PNR/OSCC model kept for its tokens (``middle=True``): its head's
    projection is never reached, and the JAX tree has none."""
    del model.head.projection
    return model


class _HOIStreamMixin(nn.Module):
    """The frozen trunks' token streams, shared by the HOI translators."""

    def __init__(self, crop_size: int = 225, alpha: int = 8,
                 beta_inv: int = 8, quant: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if quant:
            raise NotImplementedError(QUANT_NOT_PORTED)
        self.crop_size, self.alpha, self.beta_inv = crop_size, alpha, beta_inv
        self.compute_dtype = dtype

    def train(self, mode: bool = True):
        super().train(mode)
        for key in HOI_FROZEN_KEYS:
            trunk = getattr(self, key, None)
            if trunk is not None:
                trunk.eval()
        return self

    def _add_pnr(self):
        self.pnr_model = _token_trunk(KeyframeLocalizationResNet(
            crop_size=self.crop_size, dtype=self.compute_dtype))

    def _add_oscc(self):
        self.oscc_model = _token_trunk(StateChangeClsResNet(
            crop_size=self.crop_size, no_temp_pool=True,
            dtype=self.compute_dtype))

    def _add_action(self):
        self.action_model = SlowFast(alpha=self.alpha, beta_inv=self.beta_inv,
                                     dtype=self.compute_dtype)

    @property
    def _tokens(self) -> int:
        """Features of a PNR/OSCC token (8192 at crop 225)."""
        trunk = (self.pnr_model if hasattr(self, "pnr_model")
                 else self.oscc_model)
        return trunk.tokens

    def _pnr_tokens(self, frames):
        """(B, T, 8192) per-frame tokens of the frozen PNR trunk."""
        with torch.no_grad():
            return self.pnr_model(frames, middle=True)

    def _oscc_tokens(self, frames):
        with torch.no_grad():
            return self.oscc_model(frames, middle=True)

    def _action_maps(self, pathways):
        with torch.no_grad():
            return self.action_model(pathways)

    def _action_token_streams(self, pathways):
        """Slow tokens (B, T_a / alpha, 2048) and adaptive-pooled fast
        tokens (B, FAST_TOKENS, 256): each res5 map's spatial mean a
        frame."""
        slow, fast = self._action_maps(pathways)
        with torch.no_grad():
            return (slow.mean((3, 4)).transpose(1, 2),
                    adaptive_avg_pool_time(fast.mean((3, 4)).transpose(1, 2),
                                           FAST_TOKENS))

    def _add_projections(self, dim: int):
        """``proj1``, ``proj2`` (PNR, OSCC tokens), ``proj3_slow`` and
        ``proj3_fast`` to ``dim``."""
        self.proj1 = Linear(self._tokens, dim)
        self.proj2 = Linear(self._tokens, dim)
        self.proj3_slow = Linear(TRUNK_CHANNELS, dim)
        self.proj3_fast = Linear(TRUNK_CHANNELS // self.beta_inv, dim)

    def _four_streams(self, frames, pathways):
        """The four projected token streams, in concat order."""
        slow, fast = self._action_token_streams(pathways)
        return [self.proj1(self._pnr_tokens(frames)),
                self.proj2(self._oscc_tokens(frames)),
                self.proj3_slow(slow), self.proj3_fast(fast)]

    def _sequence_len(self, pnr_frames: int, action_frames: int) -> int:
        return 2 * pnr_frames + action_frames // self.alpha + FAST_TOKENS


class TokenFusionCore(nn.Module):
    """LN + learned PE + post-LN encoder + token mean (+ the same LN with
    ``norm_pooled``): (B, L, D) -> (B, D)."""

    def __init__(self, sequence_len: int, feature_dim: int,
                 num_heads: int = 8, num_layers: int = 3,
                 dropout: float = 0.1, norm_pooled: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.norm_pooled = norm_pooled
        self.ln = layer_norm(feature_dim)
        self.pe = nn.Parameter(torch.randn(1, sequence_len, feature_dim))
        self.transformer = TransformerEncoder(
            num_layers, feature_dim, num_heads,
            dim_feedforward=2 * feature_dim, dropout=dropout,
            dtype=dtype)

    def forward(self, tokens):
        if tokens.shape[1] != self.pe.shape[1]:
            raise ValueError(f"{tokens.shape[1]} tokens: the learned PE "
                             f"holds {self.pe.shape[1]}")
        pooled = self.transformer(self.ln(tokens) + self.pe).mean(dim=1)
        return self.ln(pooled) if self.norm_pooled else pooled


@MODEL_REGISTRY.register(name="TaskFusionMFTransformer3TaskDropout")
class TaskFusionMFTransformer3TaskDropout(_HOIStreamMixin):
    """ts_pnr (``target="keyframe"``, D 128, 6 layers) and ts_oscc
    (``"state"``, D 256, 5 layers): (B, 16) or (B, 2) logits."""

    def __init__(self, target: str = "keyframe", feature_dim: int = 128,
                 num_layers: int = 1, num_heads: int = 8,
                 pnr_frames: int = 16, action_frames: int = 32, **kw):
        super().__init__(**kw)
        n_out = _n_out(target)
        self._add_pnr()
        self._add_oscc()
        self._add_action()
        self._add_projections(feature_dim)
        self.dropout = Dropout(FEAT_DROPOUT)
        self.core = TokenFusionCore(
            self._sequence_len(pnr_frames, action_frames), feature_dim,
            num_heads, num_layers, TRANSFORMER_DROPOUT, norm_pooled=True,
            dtype=self.compute_dtype)
        self.head_fc = Linear(feature_dim, n_out)

    def forward(self, frames, pathways):
        streams = self._four_streams(frames, pathways)
        tokens = torch.cat([self.dropout(s) for s in streams], dim=1)
        return self.head_fc(self.core(tokens))


# ---- transfer and late-fusion baselines --------------------------------

class DupFeatHead(nn.Module):
    """cat(feat, feat) -> ``fc1`` -> 512 -> ReLU -> ``fc2`` (the
    reference's dimension-consistency trick)."""

    def __init__(self, dim_in: int, num_classes: int):
        super().__init__()
        self.fc1 = Linear(2 * dim_in, 512)
        self.fc2 = Linear(512, num_classes)

    def forward(self, feat):
        return self.fc2(torch.relu(self.fc1(torch.cat([feat, feat], dim=1))))


class _TrunkTransfer(_HOIStreamMixin):
    """One trunk's token mean through ``DupFeatHead``."""

    trunk = "pnr"
    n_out = 2

    def __init__(self, **kw):
        super().__init__(**kw)
        if self.trunk == "pnr":
            self._add_pnr()
        else:
            self._add_oscc()
        self.head = DupFeatHead(self._tokens, self.n_out)

    def forward(self, frames, pathways=None):
        tokens = (self._pnr_tokens(frames) if self.trunk == "pnr"
                  else self._oscc_tokens(frames))
        return self.head(tokens.mean(dim=1))


@MODEL_REGISTRY.register(name="Keyframe2State")
class Keyframe2State(_TrunkTransfer):
    trunk, n_out = "pnr", 2


@MODEL_REGISTRY.register(name="State2Keyframe")
class State2Keyframe(_TrunkTransfer):
    trunk, n_out = "oscc", 16


@MODEL_REGISTRY.register(name="FinetuneState")
class FinetuneState(_TrunkTransfer):
    trunk, n_out = "oscc", 2


@MODEL_REGISTRY.register(name="FinetuneKeyframe")
class FinetuneKeyframe(_TrunkTransfer):
    trunk, n_out = "pnr", 16


class _ActionTransfer(_HOIStreamMixin):
    """The frozen SlowFast and its frozen one-output ``action_head``,
    ReLU, ``fc1``."""

    n_out = 2

    def __init__(self, feature_dim: int = 2048, **kw):
        super().__init__(**kw)
        self._add_action()
        self.action_head = MultiTaskHead(head_dim(self.beta_inv),
                                         (feature_dim,))
        self.fc1 = Linear(feature_dim, self.n_out)

    def forward(self, frames, pathways):
        maps = self._action_maps(pathways)
        with torch.no_grad():
            feat = self.action_head(maps)[0]
        return self.fc1(torch.relu(feat))


@MODEL_REGISTRY.register(name="Action2State")
class Action2State(_ActionTransfer):
    n_out = 2


@MODEL_REGISTRY.register(name="Action2Keyframe")
class Action2Keyframe(_ActionTransfer):
    n_out = 16


@MODEL_REGISTRY.register(name="TaskFusionMFTransformer2TaskPnr")
class TaskFusionMFTransformer2TaskPnr(_HOIStreamMixin):
    """The PNR and OSCC streams' 32-token mid fusion."""

    def __init__(self, target: str = "keyframe", feature_dim: int = 128,
                 num_layers: int = 1, num_heads: int = 8,
                 pnr_frames: int = 16, **kw):
        super().__init__(**kw)
        n_out = _n_out(target)
        self._add_pnr()
        self._add_oscc()
        self.proj1 = Linear(self._tokens, feature_dim)
        self.proj2 = Linear(self._tokens, feature_dim)
        self.dropout = Dropout(FEAT_DROPOUT)
        self.core = TokenFusionCore(2 * pnr_frames, feature_dim, num_heads,
                                    num_layers, TRANSFORMER_DROPOUT,
                                    dtype=self.compute_dtype)
        self.head_fc = Linear(feature_dim, n_out)

    def forward(self, frames, pathways=None):
        pnr = self.dropout(self.proj1(self._pnr_tokens(frames)))
        oscc = self.dropout(self.proj2(self._oscc_tokens(frames)))
        return self.head_fc(self.core(torch.cat([pnr, oscc], dim=1)))


@MODEL_REGISTRY.register(name="TaskFusionLFLinearPnr")
class TaskFusionLFLinearPnr(_HOIStreamMixin):
    """The PNR and OSCC token means joined, ``fc1`` -> 512, ReLU, ``fc2``."""

    def __init__(self, target: str = "keyframe", **kw):
        super().__init__(**kw)
        n_out = _n_out(target)
        self._add_pnr()
        self._add_oscc()
        self.fc1 = Linear(2 * self._tokens, 512)
        self.fc2 = Linear(512, n_out)

    def forward(self, frames, pathways=None):
        feat = torch.cat([self._pnr_tokens(frames).mean(dim=1),
                          self._oscc_tokens(frames).mean(dim=1)], dim=1)
        return self.fc2(torch.relu(self.fc1(feat)))


@MODEL_REGISTRY.register(name="TaskFusionMFTransformer3TaskPnr")
class TaskFusionMFTransformer3TaskPnr(_HOIStreamMixin):
    """The 48 tokens through the pre-LN simple_vit encoder, the shared-LN
    head; no feature dropout."""

    def __init__(self, target: str = "keyframe", feature_dim: int = 256,
                 depth: int = 3, num_heads: int = 8, dim_head: int = 128,
                 mlp_dim: int = 512, pnr_frames: int = 16,
                 action_frames: int = 32, **kw):
        super().__init__(**kw)
        n_out = _n_out(target)
        self._add_pnr()
        self._add_oscc()
        self._add_action()
        self._add_projections(feature_dim)
        self.ln = layer_norm(feature_dim)
        self.pe = nn.Parameter(torch.randn(
            1, self._sequence_len(pnr_frames, action_frames), feature_dim))
        self.transformer = SimpleViTEncoder(feature_dim, depth, num_heads,
                                            dim_head, mlp_dim,
                                            self.compute_dtype)
        self.head_fc = Linear(feature_dim, n_out)

    def forward(self, frames, pathways):
        tokens = torch.cat(self._four_streams(frames, pathways), dim=1)
        x = self.transformer(self.ln(tokens) + self.pe)
        # flax's LayerNorm(dtype) emits its dtype from the f32 stream
        pooled = self.ln(x.mean(dim=1)).to(self.compute_dtype)
        return self.head_fc(pooled)


@MODEL_REGISTRY.register(name="TaskFusionLFLinear3TaskPnr")
class TaskFusionLFLinear3TaskPnr(_HOIStreamMixin):
    """The four streams projected to D 512, their token mean, ReLU,
    ``fc1``."""

    def __init__(self, target: str = "keyframe", feature_dim: int = 512,
                 **kw):
        super().__init__(**kw)
        n_out = _n_out(target)
        self._add_pnr()
        self._add_oscc()
        self._add_action()
        self._add_projections(feature_dim)
        self.fc1 = Linear(feature_dim, n_out)

    def forward(self, frames, pathways):
        feat = torch.cat(self._four_streams(frames, pathways),
                         dim=1).mean(dim=1)
        return self.fc1(torch.relu(feat))


class _ThreeFeatures(_HOIStreamMixin):
    """The PNR and OSCC token means projected to D and the live
    ``action_head``'s D-d feature of the frozen SlowFast maps."""

    def __init__(self, feature_dim: int = 128, **kw):
        super().__init__(**kw)
        self._add_pnr()
        self._add_oscc()
        self._add_action()
        self.proj1 = Linear(self._tokens, feature_dim)
        self.proj2 = Linear(self._tokens, feature_dim)
        self.action_head = MultiTaskHead(head_dim(self.beta_inv),
                                         (feature_dim,))

    def _features(self, frames, pathways):
        return (self.proj1(self._pnr_tokens(frames).mean(dim=1)),
                self.proj2(self._oscc_tokens(frames).mean(dim=1)),
                self.action_head(self._action_maps(pathways))[0])


@MODEL_REGISTRY.register(name="TaskFusionLFLinear3TaskSimple")
class TaskFusionLFLinear3TaskSimple(_ThreeFeatures):
    """The three features joined (3 D), ReLU, ``fc1``."""

    def __init__(self, target: str = "keyframe", feature_dim: int = 128,
                 **kw):
        super().__init__(feature_dim, **kw)
        self.fc1 = Linear(3 * feature_dim, _n_out(target))

    def forward(self, frames, pathways):
        feat = torch.cat(self._features(frames, pathways), dim=1)
        return self.fc1(torch.relu(feat))


@MODEL_REGISTRY.register(name="TaskFusionLFTransformer3TaskDropout")
class TaskFusionLFTransformer3TaskDropout(_ThreeFeatures):
    """The three features as 3 tokens with feature dropout, through
    ``core`` (``norm_pooled``), ``head_fc``."""

    def __init__(self, target: str = "keyframe", feature_dim: int = 128,
                 num_layers: int = 1, num_heads: int = 8, **kw):
        super().__init__(feature_dim, **kw)
        n_out = _n_out(target)
        self.dropout = Dropout(FEAT_DROPOUT)
        self.core = TokenFusionCore(3, feature_dim, num_heads, num_layers,
                                    TRANSFORMER_DROPOUT, norm_pooled=True,
                                    dtype=self.compute_dtype)
        self.head_fc = Linear(feature_dim, n_out)

    def forward(self, frames, pathways):
        tokens = torch.stack([self.dropout(f) for f in
                              self._features(frames, pathways)], dim=1)
        return self.head_fc(self.core(tokens))
