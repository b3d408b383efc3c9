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
unless ``device`` says otherwise; its loaders bucket the four streams of
``data/ttm_2task.py``.
"""

from __future__ import annotations

from egot2x_torch.core import bridge
from egot2x_torch.core.checkpoint import graft_stage1
from egot2x_torch.data.ttm import TtmSegmentDataset
from egot2x_torch.data.ttm_2task import TtmTwoTaskDataset
from egot2x_torch.tasks.ttm import TalkingToMe
from egot2x_torch.train.state import TrainState, split_params
from egot2x_torch.translate.egot2s_hhi import FROZEN_KEYS


class TalkingToMe2Loader(TalkingToMe):
    def __init__(self, cfg, device=None):
        if cfg.get("quant_trunks") and cfg.get("nofreeze"):
            raise ValueError(
                "quant_trunks requires frozen trunks: the int8 conv path "
                "has no gradient (nofreeze differentiates the backbones)")
        kwargs = dict(
            hidden_dim=cfg.get("hidden_dim", 256),
            num_heads=cfg.get("num_heads", 4),
            num_layers=cfg.get("num_layers", 3),
            dropout=cfg.get("dropout", 0.1),
            nofreeze=cfg.get("nofreeze", False),
            remat=cfg.get("remat", False))
        if cfg.get("quant_trunks"):
            kwargs["quant"] = True
        super().__init__(cfg, device, **kwargs)

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
        return TrainState(model, self._optimizer(trainable))

    def _model_inputs(self, batch):
        return (batch["frames"], batch["video_asd"], batch["audio"],
                batch["audio_asd"])

    def _dataset(self, split):
        c = self.cfg
        return TtmTwoTaskDataset(c.data_root, split=split,
                                 img_size=c.img_size, device=self.device)


class TalkingToMe2Task(TalkingToMe2Loader):
    """The LAM + TTM translator (``TaskFusionMFTransformer2Task``) on
    batches of ``frames`` and ``audio``."""

    def _model_inputs(self, batch):
        return (batch["frames"], batch["audio"])

    def _dataset(self, split):
        c = self.cfg
        return TtmSegmentDataset(c.data_root, split=split,
                                 img_size=c.img_size, device=self.device)
