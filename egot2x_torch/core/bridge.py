"""Weight bridge between the JAX package's variable trees and the port.

``from_jax_variables(model, {"params": ..., "batch_stats": ...})`` turns
an ``egot2x`` variable tree (numpy leaves) into a ``state_dict`` for the
port module that mirrors it; ``to_jax_variables`` goes back. A quant model
also carries the ``quant`` collection: ``act_max`` of each int8 conv,
``stem_act_max`` of each stem and ``out_act_max`` of each block or AVSR
layer that emits int8, as scalar buffers of the module that owns them.
The layouts differ as follows:

  * Dense kernels are (in, out), torch Linear weights (out, in);
  * conv kernels are HWIO / THWIO / (K, I, O) (the depthwise conv1d is
    (K, 1, C)), torch weights are OIHW / OITHW / (O, I, K);
  * Flax MHA has separate q/k/v Dense layers, packed here into torch's
    ``in_proj_weight`` / ``in_proj_bias``;
  * BatchNorm keeps ``mean``/``var`` in ``batch_stats``; gLN's gamma/beta
    are (C,) in JAX and (1, C, 1) here;
  * the BiLSTM's ``w_ih`` (D, 4H) and ``w_hh`` (H, 4H) of each layer and
    direction are torch LSTM's ``weight_ih_l{k}[_reverse]`` (4H, D) and
    ``weight_hh_l{k}[_reverse]`` (4H, H), biases as they are;
  * ResNetSE's attention Dense layers are 1x1 Conv1d here, (out, in, 1);
  * the ResNet3D models (``nn/resnet3d.py``, ``models/pnr.py``) and the
    TTM baselines' heads have the JAX package's names, so each module's
    path is its JAX path with "/" for ".";
  * SlowFast and the AR models (``nn/slowfast.py``, ``models/ar_lta.py``)
    and the HOI translators (``translate/egot2s_hoi.py``) have the JAX
    package's names too, but the HOI cores' encoder layers
    (``transformer.layers.{i}``, JAX ``transformer/layers_{i}``); a core's
    learned ``pe`` is a parameter of the module that owns it, as in JAX;
  * the EgoT2-g prompt models hold their prompt core (``ln``,
    ``task_embed``, ``embedding``, ``fc``, the encoder and the decoder)
    at their top, as the reference does, and the JAX package under
    ``core/``; flax's ``Embed`` table is torch's ``Embedding`` weight as
    it is.

The map is written module by module: each entry pairs a port module path
with a JAX module path, and the module's type says which leaves it has.
Both directions check that every leaf on either side was used, so a name
that drifts fails loudly. Models that wrap another (``TalkNetWithHeads``
around TalkNet, ``_TranslatorWithHead`` around an ASD translator) take
the wrapped model's map under its path on either side, plus their heads.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from egot2x_torch.models.ar_lta import MultiTaskSlowFast, SlowFastFeature
from egot2x_torch.models.asd import TalkNetBackbone, TalkNetWithHeads
from egot2x_torch.models.lam import BaselineLSTM
from egot2x_torch.models.pnr import KeyframeCnnLSTM, _PnrResNet
from egot2x_torch.models.ttm import TTMBaselineLSTM
from egot2x_torch.nn.common import (MultiHeadAttention, TransformerDecoder,
                                    TransformerEncoder)
from egot2x_torch.nn.lstm import BiLSTM
from egot2x_torch.nn.quant import SCALE_BUFFERS
from egot2x_torch.nn.resnet2d import BasicBlock2D, ResNet2D
from egot2x_torch.nn.resnet3d import ResNet3D
from egot2x_torch.nn.resnet_se import ResNetSE
from egot2x_torch.nn.slowfast import SlowFast
from egot2x_torch.nn.talknet import (AVSRResNetLayer, CrossAttentionLayer,
                                     GlobalLayerNorm, TalkNetModel,
                                     VisualFrontend)
from egot2x_torch.tasks.asd_2loader import _TranslatorWithHead
from egot2x_torch.translate.egot2g import STREAM_IDS, _HHIPromptBase
from egot2x_torch.translate.egot2s_hhi import (FROZEN_KEYS, _FrameBaseline,
                                               _MFTransformerCore,
                                               _TTMBaseline)
from egot2x_torch.translate.egot2s_hoi import TokenFusionCore, _HOIStreamMixin

# (torch key, [(collection, jax path)], layout)
Rule = Tuple[str, List[Tuple[str, Tuple[str, ...]]], str]

_TO_TORCH = {
    "id": lambda a: a[0],
    "linear": lambda a: a[0].T,
    "conv1d": lambda a: a[0].transpose(2, 1, 0),
    "conv2d": lambda a: a[0].transpose(3, 2, 0, 1),
    "conv3d": lambda a: a[0].transpose(4, 3, 0, 1, 2),
    "gln": lambda a: a[0].reshape(1, -1, 1),
    "pointwise": lambda a: a[0].T[:, :, None],
    "qkv_w": lambda a: np.concatenate([w.T for w in a], axis=0),
    "qkv_b": lambda a: np.concatenate(a, axis=0),
}
_TO_JAX = {
    "id": lambda t: [t],
    "linear": lambda t: [t.T],
    "conv1d": lambda t: [t.transpose(2, 1, 0)],
    "conv2d": lambda t: [t.transpose(2, 3, 1, 0)],
    "conv3d": lambda t: [t.transpose(2, 3, 4, 1, 0)],
    "gln": lambda t: [t.reshape(-1)],
    "pointwise": lambda t: [t[:, :, 0].T],
    "qkv_w": lambda t: [w.T for w in np.split(t, 3, axis=0)],
    "qkv_b": lambda t: np.split(t, 3, axis=0),
}


def _p(path: str) -> Tuple[str, ...]:
    return tuple(p for p in path.split("/") if p)


def _leaf_rules(module: nn.Module, t: str, j: str) -> List[Rule]:
    """Leaf rules of one port module ``t`` mirroring JAX module ``j``."""
    t = t + "." if t else ""
    prm = lambda leaf: ("params", _p(f"{j}/{leaf}"))
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        layout = {3: "conv1d", 4: "conv2d", 5: "conv3d"}[module.weight.dim()]
        rules = [(t + "weight", [prm("kernel")], layout)]
        if module.bias is not None:
            rules.append((t + "bias", [prm("bias")], "id"))
        return rules
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return [(t + "weight", [prm("scale")], "id"),
                (t + "bias", [prm("bias")], "id"),
                (t + "running_mean", [("batch_stats", _p(f"{j}/mean"))], "id"),
                (t + "running_var", [("batch_stats", _p(f"{j}/var"))], "id")]
    if isinstance(module, nn.Linear):
        rules = [(t + "weight", [prm("kernel")], "linear")]
        if module.bias is not None:
            rules.append((t + "bias", [prm("bias")], "id"))
        return rules
    if isinstance(module, nn.LayerNorm):
        return [(t + "weight", [prm("scale")], "id"),
                (t + "bias", [prm("bias")], "id")]
    if isinstance(module, nn.Embedding):
        return [(t + "weight", [prm("embedding")], "id")]
    if isinstance(module, MultiHeadAttention):
        qkv = ("q_proj", "k_proj", "v_proj")
        return [(t + "in_proj_weight", [prm(f"{n}/kernel") for n in qkv],
                 "qkv_w"),
                (t + "in_proj_bias", [prm(f"{n}/bias") for n in qkv], "qkv_b"),
                *_leaf_rules(module.out_proj, t + "out_proj", f"{j}/out_proj")]
    if isinstance(module, (TokenFusionCore, _HOIStreamMixin)):
        return [(t + "pe", [prm("pe")], "id")]   # the learned PE
    if isinstance(module, GlobalLayerNorm):
        return [(t + "gamma", [prm("gamma")], "gln"),
                (t + "beta", [prm("beta")], "gln")]
    if isinstance(module, nn.PReLU):  # its alpha lives on the JAX block
        return [(t + "weight", [prm("prelu_alpha")], "id")]
    if isinstance(module, BiLSTM):
        rules = []
        for k in range(module.num_layers):
            for sfx, d in (("", "fwd"), ("_reverse", "bwd")):
                cell = f"l{k}_{d}"
                rules += [
                    (f"{t}weight_ih_l{k}{sfx}", [prm(f"{cell}/w_ih")],
                     "linear"),
                    (f"{t}weight_hh_l{k}{sfx}", [prm(f"{cell}/w_hh")],
                     "linear"),
                    (f"{t}bias_ih_l{k}{sfx}", [prm(f"{cell}/b_ih")], "id"),
                    (f"{t}bias_hh_l{k}{sfx}", [prm(f"{cell}/b_hh")], "id")]
        return rules
    if isinstance(module, (ResNet2D, BasicBlock2D, VisualFrontend,
                           AVSRResNetLayer)):
        return []  # only int8 scales of its own (_scale_rules)
    raise TypeError(f"no bridge rule for {type(module).__name__} at {t!r}")


def _scale_rules(module: nn.Module, t: str, j: str) -> List[Rule]:
    """Rules of the int8 scales ``module`` owns itself (``quant``)."""
    t = t + "." if t else ""
    own = dict(module.named_buffers(recurse=False))
    return [(t + name, [("quant", _p(f"{j}/{name}"))], "id")
            for name in SCALE_BUFFERS if name in own]


def _resnet2d(t: str, j: str, stage_sizes=(2, 2, 2, 2)
              ) -> Iterator[Tuple[str, str]]:
    """A ResNet2D of ``stage_sizes`` (ResNet-18's by default); its head,
    where it has one."""
    yield from ((t.rstrip("."), j), (f"{t}conv1", f"{j}/conv1"),
                (f"{t}bn1", f"{j}/bn1"), (f"{t}fc", f"{j}/fc"),
                (f"{t}fc2", f"{j}/fc2"))
    for stage, blocks in enumerate(stage_sizes, start=1):
        for b in range(blocks):
            tp, jp = f"{t}layer{stage}.{b}", f"{j}/layer{stage}_{b}"
            yield tp, jp
            for leaf in ("conv1", "bn1", "conv2", "bn2"):
                yield f"{tp}.{leaf}", f"{jp}/{leaf}"
            yield f"{tp}.downsample.0", f"{jp}/downsample_conv"
            yield f"{tp}.downsample.1", f"{jp}/downsample_bn"


def _resnet_se(t: str, j: str) -> Iterator[Tuple[str, str]]:
    """ResNetSE's modules but its attention's 1x1 convs
    (``_pointwise_rules``)."""
    yield from ((f"{t}conv1", f"{j}/conv1"), (f"{t}bn1", f"{j}/bn1"),
                (f"{t}attention.2", f"{j}/att_bn"), (f"{t}fc", f"{j}/fc"))
    for stage in range(1, 5):
        for b in range(2):
            tp, jp = f"{t}layer{stage}.{b}", f"{j}/layer{stage}_{b}"
            for leaf in ("conv1", "bn1", "conv2", "bn2"):
                yield f"{tp}.{leaf}", f"{jp}/{leaf}"
            yield f"{tp}.se.fc.0", f"{jp}/se/fc0"
            yield f"{tp}.se.fc.2", f"{jp}/se/fc1"
            yield f"{tp}.downsample.0", f"{jp}/downsample_conv"
            yield f"{tp}.downsample.1", f"{jp}/downsample_bn"


def _mirror(model: nn.Module, skip=()) -> Iterator[Tuple[str, str]]:
    """Every module of ``model`` that holds leaves of its own, at the JAX
    path that is its port path with "/" for "." (the ResNet3D models and
    the baselines' heads are named as in the JAX package), but those
    under the top-level names ``skip``."""
    for name, m in model.named_modules():
        if name.split(".", 1)[0] in skip:
            continue
        if any(True for _ in m.parameters(recurse=False)):
            yield name, name.replace(".", "/")


def _pointwise_rules(t: str, j: str) -> List[Rule]:
    """ResNetSE's attention convs, Dense layers in the JAX package."""
    rules = []
    for k, name in ((0, "att_fc0"), (3, "att_fc1")):
        rules += [(f"{t}attention.{k}.weight",
                   [("params", _p(f"{j}/{name}/kernel"))], "pointwise"),
                  (f"{t}attention.{k}.bias",
                   [("params", _p(f"{j}/{name}/bias"))], "id")]
    return rules


def _stage1_head(trunk: str) -> Iterator[Tuple[str, str]]:
    """A LAM or TTM Stage-I classifier's ResNet-18 (its attribute
    ``trunk``), BiLSTM and head; the JAX model holds the first two under
    ``trunk/``."""
    yield from _resnet2d(f"{trunk}.", f"trunk/{trunk}")
    yield from (("lstm", "trunk/lstm"), ("last_layer1", "last_layer1"),
                ("last_layer2", "last_layer2"))


def _attention_layer(t: str, j: str) -> Iterator[Tuple[str, str]]:
    for leaf in ("self_attn", "linear1", "linear2", "norm1", "norm2"):
        yield f"{t}.{leaf}", f"{j}/{leaf}"


def _encoder(t: str, j: str, num_layers: int) -> Iterator[Tuple[str, str]]:
    for i in range(num_layers):
        yield from _attention_layer(f"{t}layers.{i}", f"{j}/layers_{i}")


def _decoder(t: str, j: str, num_layers: int) -> Iterator[Tuple[str, str]]:
    for i in range(num_layers):
        for leaf in ("self_attn", "multihead_attn", "linear1", "linear2",
                     "norm1", "norm2", "norm3"):
            yield f"{t}layers.{i}.{leaf}", f"{j}/layers_{i}/{leaf}"


def _talknet(t: str, j: str) -> Iterator[Tuple[str, str]]:
    vf, jvf = f"{t}visualFrontend", f"{j}/visual_frontend"
    yield vf, jvf
    yield f"{vf}.frontend3D.0", f"{jvf}/frontend3d_conv"
    yield f"{vf}.frontend3D.1", f"{jvf}/frontend3d_bn"
    for i in range(1, 5):
        yield f"{vf}.resnet.layer{i}", f"{jvf}/layer{i}"
        for leaf in ("conv1a", "bn1a", "conv2a", "downsample", "outbna",
                     "conv1b", "bn1b", "conv2b", "outbnb"):
            yield f"{vf}.resnet.layer{i}.{leaf}", f"{jvf}/layer{i}/{leaf}"
    for i in range(5):
        tp, jp = f"{t}visualTCN.net.{i}.net", f"{j}/visual_tcn/block{i}"
        for k, leaf in ((1, "/bn"), (2, "/depthwise"), (3, ""), (4, "/gln"),
                        (5, "/pointwise")):
            yield f"{tp}.{k}", jp + leaf
    for k, leaf in ((0, "conv5"), (1, "bn"), (3, "conv1")):
        yield f"{t}visualConv1D.net.{k}", f"{j}/visual_conv1d/{leaf}"
    ae, jae = f"{t}audioEncoder", f"{j}/audio_encoder"
    yield f"{ae}.conv1", f"{jae}/conv1"
    yield f"{ae}.bn1", f"{jae}/bn1"
    for layer, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            tp, jp = f"{ae}.layer{layer}.{b}", f"{jae}/layer{layer}_{b}"
            for leaf in ("conv1", "bn1", "conv2", "bn2"):
                yield f"{tp}.{leaf}", f"{jp}/{leaf}"
            yield f"{tp}.se.fc.0", f"{jp}/se_fc0"
            yield f"{tp}.se.fc.2", f"{jp}/se_fc1"
            yield f"{tp}.downsample.0", f"{jp}/downsample_conv"
            yield f"{tp}.downsample.1", f"{jp}/downsample_bn"
    for tn, jn in (("crossA2V", "cross_a2v"), ("crossV2A", "cross_v2a"),
                   ("selfAV", "self_av")):
        yield from _attention_layer(f"{t}{tn}", f"{j}/{jn}")


def _trunks(model: nn.Module) -> Iterator[Tuple[str, str]]:
    """The frozen backbones a translator holds."""
    if hasattr(model, "lam_model"):
        yield from _resnet2d("lam_model.base_model.",
                             "lam_model/trunk/base_model")
    if hasattr(model, "ttm_model"):
        yield from _resnet2d("ttm_model.video_encoder.",
                             "ttm_model/trunk/video_encoder")
    if hasattr(model, "asd_model"):
        yield from _talknet("asd_model.", "asd_model")


def _translator(model: _MFTransformerCore) -> Iterator[Tuple[str, str]]:
    yield from _trunks(model)
    for s in model.streams:
        yield f"proj_{s}", f"core/proj_{s}"
    yield "ln", "core/ln"
    yield from _encoder("transformer_encoder.", "core/transformer_encoder",
                        len(model.transformer_encoder.layers))
    yield "linear_head.0", "head_ln"   # absent from the ASD variant
    yield "linear_head.1", "head_fc"


def _prompt(model: _HHIPromptBase) -> Iterator[Tuple[str, str]]:
    yield from _trunks(model)
    for s in STREAM_IDS:
        yield f"proj_{s}", f"proj_{s}"
    for leaf in ("ln", "embedding", "fc"):
        yield leaf, f"core/{leaf}"
    yield from _encoder("transformer_encoder.", "core/transformer_encoder",
                        len(model.transformer_encoder.layers))
    yield from _decoder("transformer_decoder.", "core/transformer_decoder",
                        len(model.transformer_decoder.layers))


def _hoi(model: _HOIStreamMixin) -> Iterator[Tuple[str, str]]:
    """An HOI translator: its modules at their JAX paths, the core's
    encoder layers renamed."""
    yield from _mirror(model, skip=("core",))
    if hasattr(model, "core"):
        yield from (("core", "core"), ("core.ln", "core/ln"))
        yield from _encoder("core.transformer.", "core/transformer",
                            len(model.core.transformer.layers))


def _nested(module: nn.Module, t: str, j: str) -> List[Rule]:
    """``bridge_rules(module)`` for a submodule at port path ``t`` and JAX
    path ``j``."""
    return [(f"{t}.{key}", [(coll, _p(j) + path) for coll, path in sources],
             layout) for key, sources, layout in bridge_rules(module)]


def bridge_rules(model: nn.Module) -> List[Rule]:
    """Every leaf rule between ``model`` and the JAX tree it mirrors."""
    if isinstance(model, TalkNetWithHeads):
        heads = (("lossAV", "fc_av"), ("lossA", "fc_a"), ("lossV", "fc_v"))
        return _nested(model.model, "model", "talknet") + [
            r for t, j in heads
            for r in _leaf_rules(getattr(model, t).FC, f"{t}.FC", j)]
    if isinstance(model, _TranslatorWithHead):
        return (_nested(model.translator, "translator", "translator")
                + _leaf_rules(model.lossAV.FC, "lossAV.FC", "loss_av/fc"))
    task_embed = ("task_embed", [("params", ("core", "task_embed"))], "id")
    if isinstance(model, _MFTransformerCore):
        pairs, extra = _translator(model), [task_embed]
    elif isinstance(model, _HHIPromptBase):
        pairs, extra = _prompt(model), [task_embed]
    elif isinstance(model, BaselineLSTM):
        pairs, extra = _stage1_head("base_model"), []
    elif isinstance(model, TTMBaselineLSTM):
        pairs = [*_stage1_head("video_encoder"),
                 *_resnet_se("audio_encoder.", "trunk/audio_encoder")]
        extra = _pointwise_rules("audio_encoder.", "trunk/audio_encoder")
    elif isinstance(model, ResNetSE):
        pairs, extra = _resnet_se("", ""), _pointwise_rules("", "")
    elif isinstance(model, BiLSTM):
        pairs, extra = [("", "")], []
    elif isinstance(model, _FrameBaseline):
        pairs = [*_trunks(model), ("fc1", "fc1")]
        extra = []
    elif isinstance(model, _TTMBaseline):
        pairs = [*_trunks(model), *_mirror(model, skip=FROZEN_KEYS)]
        extra = []
    elif isinstance(model, (_PnrResNet, ResNet3D, SlowFast,
                            MultiTaskSlowFast, SlowFastFeature)):
        pairs, extra = _mirror(model), []
    elif isinstance(model, _HOIStreamMixin):
        pairs, extra = _hoi(model), []
    elif isinstance(model, KeyframeCnnLSTM):
        pairs = [*_resnet2d("backbone.", "backbone",
                            model.backbone.stage_sizes),
                 ("lstm", "lstm"), ("regressor", "regressor")]
        extra = []
    elif isinstance(model, TalkNetBackbone):
        pairs, extra = _talknet("", "talknet"), []
    elif isinstance(model, ResNet2D):
        pairs, extra = _resnet2d("", "", model.stage_sizes), []
    elif isinstance(model, TalkNetModel):
        pairs, extra = _talknet("", ""), []
    elif isinstance(model, TransformerEncoder):
        pairs, extra = _encoder("", "", len(model.layers)), []
    elif isinstance(model, TransformerDecoder):
        pairs, extra = _decoder("", "", len(model.layers)), []
    elif isinstance(model, CrossAttentionLayer):
        pairs = [(leaf, leaf) for leaf in ("self_attn", "linear1", "linear2",
                                           "norm1", "norm2")]
        extra = []
    else:
        raise TypeError(f"no bridge for {type(model).__name__}")
    modules = dict(model.named_modules())
    rules = list(extra)
    for t, j in pairs:
        if t in modules:  # a block without a projection has no downsample
            rules += _leaf_rules(modules[t], t, j)
            rules += _scale_rules(modules[t], t, j)
    return rules


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):  # dict or FrozenDict
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def from_jax_variables(model: nn.Module, variables) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"[, "quant"]}`` (numpy or array leaves)
    -> a state_dict for ``model`` (every key but BN's num_batches_tracked)."""
    flat = {(coll,) + path: leaf for coll in ("params", "batch_stats", "quant")
            for path, leaf in _flatten(variables.get(coll, {})).items()}
    state, used = {}, set()
    for key, sources, layout in bridge_rules(model):
        srcs = [(coll,) + path for coll, path in sources]
        missing = [s for s in srcs if s not in flat]
        if missing:
            raise KeyError(f"{key}: JAX leaves {missing} not found")
        used.update(srcs)
        state[key] = torch.from_numpy(np.array(
            _TO_TORCH[layout]([flat[s] for s in srcs]), dtype=np.float32,
            order="C"))
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise KeyError(f"JAX leaves with no port counterpart: {unused}")
    return state


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Load a JAX variable tree into ``model`` in place; every parameter
    and statistic must be covered."""
    state = from_jax_variables(model, variables)
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"bridge mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for m in model.modules():
        if isinstance(m, nn.LSTM):   # cuDNN's one weight buffer
            m.flatten_parameters()
    return model


def to_jax_variables(model: nn.Module) -> Dict[str, dict]:
    """The port's weights as a JAX variable tree of numpy leaves."""
    state = {k: v.detach().float().cpu().numpy()
             for k, v in model.state_dict().items()}
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, sources, layout in bridge_rules(model):
        for (coll, path), leaf in zip(sources, _TO_JAX[layout](state[key])):
            node = out.setdefault(coll, {})
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = np.array(leaf, order="C")
    return out


def _jax_shapes(model: nn.Module) -> Dict[Tuple[str, ...], tuple]:
    """The shape of every leaf of ``to_jax_variables(model)``, by path,
    without copying a weight."""
    sizes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    shapes = {}
    for key, sources, layout in bridge_rules(model):
        empty = np.broadcast_to(np.float32(0), sizes[key])
        for (coll, path), leaf in zip(sources, _TO_JAX[layout](empty)):
            shapes[(coll,) + path] = np.shape(leaf)
    return shapes


def random_jax_variables(model: nn.Module, seed: int) -> Dict[str, dict]:
    """A JAX-layout variable tree for ``model`` drawn from a numpy seed:
    kernels ~ N(0, 1/fan_in), small biases, BN/LN/gLN near identity,
    running statistics near (0, 1); int8 scales 0, uncalibrated (they
    come from calibration only, and draw nothing from the seed, so a quant
    model gets the float model's weights). For runs that need weights but
    no checkpoint."""
    rng = np.random.default_rng(seed)
    template = _jax_shapes(model)
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for path in sorted(template):
        shape, leaf = template[path], path[-1]
        if leaf in SCALE_BUFFERS:
            v = np.zeros(shape)
        elif leaf == "kernel":
            v = rng.standard_normal(shape)
            v /= np.sqrt(np.prod(shape[:-1]))
        elif leaf in ("w_ih", "w_hh"):   # an LSTM's (in, 4H)
            v = rng.standard_normal(shape)
            v /= np.sqrt(shape[0])
        elif leaf in ("scale", "gamma", "var"):
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == "prelu_alpha":
            v = np.full(shape, 0.25)
        elif leaf in ("task_embed", "pe"):   # flax's normal(1.0)
            v = rng.standard_normal(shape)
        elif leaf == "embedding":   # a (vocab, D) table: rows of norm ~1
            v = rng.standard_normal(shape)
            v /= np.sqrt(shape[-1])
        else:  # bias, beta, mean
            v = rng.standard_normal(shape)
            v *= 0.05
        node = out.setdefault(path[0], {})
        for p in path[1:-1]:
            node = node.setdefault(p, {})
        node[leaf] = v.astype(np.float32)
    return out
