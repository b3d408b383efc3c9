"""TTM 2-loader task: Stage-II training of the EgoT2-s TTM translators.

Counterpart of ``egot2x/tasks/ttm_2loader.py``: the TTM task's weighted
CE and per-segment mAP, with a batch of ``frames`` (B, T, H, W, 3),
``video_asd`` (B, T, 112, 112), ``audio`` (B, S), ``audio_asd``
(B, 4T, 13) and ``label`` (B,), and a Stage-II translator over the LAM,
TTM and TalkNet backbones (``FROZEN_KEYS``): ``build_state`` grafts the
Stage-I checkpoints named by ``lam_checkpoint``, ``ttm_checkpoint`` and
``asd_checkpoint`` and hands the optimizer the translator's own
parameters only, or, with ``nofreeze``, every parameter, the backbones'
too (which still run in eval mode, so their BN statistics do not move);
``remat`` recomputes the backbones' activations in the backward under
``nofreeze``. ``quant_trunks`` runs the frozen trunks int8 (static PTQ,
calibrated by the Trainer on the first batch); they take no gradient, so
the int8 path, accuracy-gated for inference, serves training too, and
``quant_trunks`` with ``nofreeze`` is refused. The model runs on the card
unless ``device`` says otherwise.
"""

from __future__ import annotations

import torch

from egot2x_torch.core import bridge
from egot2x_torch.core.checkpoint import graft_stage1
from egot2x_torch.core.registry import build_model
from egot2x_torch.nn.common import set_dropout_generator
from egot2x_torch.tasks.base import resolve_dtype
from egot2x_torch.tasks.lam import weighted_cross_entropy
from egot2x_torch.tasks.ttm import TalkingToMe
from egot2x_torch.train.optim import construct_optimizer
from egot2x_torch.train.state import TrainState, split_params
from egot2x_torch.translate.egot2s_hhi import FROZEN_KEYS



class TalkingToMe2Loader(TalkingToMe):
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        if cfg.get("quant_trunks") and cfg.get("nofreeze"):
            raise ValueError(
                "quant_trunks requires frozen trunks: the int8 conv path "
                "has no gradient (nofreeze differentiates the backbones)")
        kwargs = dict(
            dtype=resolve_dtype(cfg), hidden_dim=cfg.get("hidden_dim", 256),
            num_heads=cfg.get("num_heads", 4),
            num_layers=cfg.get("num_layers", 3),
            dropout=cfg.get("dropout", 0.1),
            nofreeze=cfg.get("nofreeze", False),
            remat=cfg.get("remat", False))
        if cfg.get("quant_trunks"):
            kwargs["quant"] = True
        self.model = build_model(cfg.model, device=device, **kwargs)
        self.class_weights = torch.tensor(
            cfg.weights, dtype=torch.float32,
            device=next(self.model.parameters()).device)

    def build_state(self, seed: int = 0) -> TrainState:
        """Weights drawn from ``seed`` (the weight bridge's seeded tree),
        the configured Stage-I backbones grafted over them, the backbones
        frozen unless ``nofreeze``, and Adam over the rest."""
        c, model = self.cfg, self.model
        bridge.load_jax_variables(model,
                                  bridge.random_jax_variables(model, seed))
        graft_stage1(model, c)
        frozen_keys = () if c.get("nofreeze") else FROZEN_KEYS
        trainable, _ = split_params(model, lambda k: k in frozen_keys)
        optimizer = construct_optimizer(trainable, "adam", lr=c.lr,
                                        weight_decay=c.get("wd", 0.0))
        return TrainState(model, optimizer)

    def _model_inputs(self, batch):
        return (batch["frames"], batch["video_asd"], batch["audio"],
                batch["audio_asd"])

    def train_step(self, state, batch, generator):
        """One Adam step on the weighted CE of a train-mode forward whose
        dropout masks ``generator`` draws; the loss is computed in f32."""
        model = set_dropout_generator(state.model.train(), generator)
        logits = model(*self._model_inputs(batch))
        loss = weighted_cross_entropy(logits.float(), batch["label"].long(),
                                      self.class_weights)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}


class TalkingToMe2Task(TalkingToMe2Loader):
    """The LAM + TTM translator (``TaskFusionMFTransformer2Task``) on
    batches of ``frames`` and ``audio``."""

    def _model_inputs(self, batch):
        return (batch["frames"], batch["audio"])
