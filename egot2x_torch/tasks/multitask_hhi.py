"""HHI EgoT2-g tasks: the three HHI tasks as label tokens of one
prompt translator, Stage II.

Counterpart of ``egot2x/tasks/multitask_hhi.py``. A batch is ``{task:
batch}`` for the tasks ``lam``, ``ttm`` and ``asd`` (one batch of each a
step, ``data/combined.py::CombinedLoader``):

  * ``lam``: ``frames`` (B, 7, H, W, 3) and ``target_seq`` (B, 3);
  * ``ttm``: ``frames`` (B, T, H, W, 3), ``video_asd`` (B, T, 112, 112),
    ``audio`` (B, T / 30 * 16000), ``audio_asd`` (B, 4T, 13) and
    ``target_seq`` (B, 3);
  * ``asd``: ``frames``, ``faces`` (B, T, 112, 112), ``audio``, ``mfcc``
    (B, 4T, 13) and ``target_seq`` (B, T, 3), one sequence a frame;

a target sequence is [task token, label token, '</s>'] in the ids of
``translate/vocab.py``. A train step sums the three tasks' token
cross-entropies of the teacher-forced decode (``target[:, :-1]`` ->
``target[:, 1:]``) and takes one Adam step over the translator less its
frozen backbones. Validation decodes one greedy step from each task's
token (``predict``) and the teacher-forced loss; it reports each task's
accuracy, the LAM and TTM mAP over the rows of all batches, and
``val_loss``, the mean of the per-task losses, which ranks checkpoints
(lower first). The eval step encodes each task's batch once and decodes
that encoding both ways, where the JAX package's encodes it twice (the
same outputs).

``Unified3TaskTranslation`` runs ``TaskTranslationPromptTransformer``,
``Unified3Task`` the single-stream ``TaskPromptTransformer``, at
``run_multitask``'s widths unless ``cfg`` says otherwise (``hidden_dim``
256, ``num_heads`` 4, ``num_layers`` 3, ``dropout`` 0.1, ``lr`` 1e-4).
``build_state`` grafts the Stage-I checkpoints that ``lam_checkpoint``,
``ttm_checkpoint`` and ``asd_checkpoint`` name. The model runs on the
card unless ``device`` says otherwise, and so do its loaders' items:
``train_loader`` and ``val_loader`` combine LAM clips (``lam_root``,
``lam_batch`` 4, stride 1), TTM 2-loader segments (``ttm_root``) and ASD
trials with their RGB stream (``asd_root``), the last two in one bucket of
``mt_frames`` (15) frames at ``ttm_budget`` / ``asd_budget`` frames a
batch (2 ``mt_frames``), all at ``img_size``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from egot2x_torch.core import bridge
from egot2x_torch.core.checkpoint import graft_stage1
from egot2x_torch.core.registry import build_model
from egot2x_torch.data.asd import AsdSeqDataset
from egot2x_torch.data.combined import CombinedLoader
from egot2x_torch.data.lam import LamSeqDataset
from egot2x_torch.data.ttm_2task import TtmTwoTaskSeqDataset
from egot2x_torch.metrics.map import run_evaluation
from egot2x_torch.nn.common import set_dropout_generator
from egot2x_torch.tasks.base import Task, batch_loader, bucket_loader
from egot2x_torch.train.optim import construct_optimizer
from egot2x_torch.train.state import TrainState, split_params
from egot2x_torch.translate.egot2g import FROZEN_KEYS
from egot2x_torch.translate.vocab import build_hhi_vocab

TASKS = ("lam", "ttm", "asd")


def seq_ce(logits, targets):
    """Mean token cross-entropy of (B, S, V) logits against (B, S) ids,
    in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Unified3TaskTranslation(Task):
    checkpoint_metric = "val_loss"
    checkpoint_mode = "min"
    model_name = "TaskTranslationPromptTransformer"

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.vocab = build_hhi_vocab()
        self.model = build_model(
            self.model_name, device=device, vocab_size=len(self.vocab),
            hidden_dim=cfg.get("hidden_dim", 256),
            num_heads=cfg.get("num_heads", 4),
            num_layers=cfg.get("num_layers", 3),
            dropout=cfg.get("dropout", 0.1))
        self.device = next(self.model.parameters()).device
        self.n_frames = int(cfg.get("mt_frames", 15))   # one fixed bucket

    # -- data ----------------------------------------------------------------
    def _loaders(self, split):
        c, n, dev = self.cfg, self.n_frames, self.device
        mode = "train" if split == "train" else "eval"
        lam = LamSeqDataset(self.vocab, c.lam_root, split=split, stride=1,
                            img_size=c.img_size, device=dev)
        ttm = TtmTwoTaskSeqDataset(self.vocab, c.ttm_root, split=split,
                                   img_size=c.img_size, device=dev)
        asd = AsdSeqDataset(self.vocab, c.asd_root, split=split,
                            with_rgb=True, rgb_size=c.img_size, device=dev)
        return {"lam": batch_loader(c, lam, c.get("lam_batch", 4), mode),
                "ttm": bucket_loader(c, ttm, (n,), mode,
                                     c.get("ttm_budget", 2 * n)),
                "asd": bucket_loader(c, asd, (n,), mode,
                                     c.get("asd_budget", 2 * n))}

    def train_loader(self):
        return CombinedLoader(self._loaders("train"))

    def val_loader(self):
        return CombinedLoader(self._loaders("val"))

    def build_state(self, seed: int = 0) -> TrainState:
        """Weights drawn from ``seed`` (the weight bridge's seeded tree),
        the configured Stage-I backbones grafted over them, the backbones
        frozen, and Adam at ``lr`` over the rest."""
        model = self.model
        bridge.load_jax_variables(model,
                                  bridge.random_jax_variables(model, seed))
        graft_stage1(model, self.cfg)
        trainable, _ = split_params(model, lambda k: k in FROZEN_KEYS)
        return TrainState(model, construct_optimizer(
            trainable, "adam", lr=self.cfg.get("lr", 1e-4)))

    def _task_args(self, task, batch):
        """(video, video_asd, audio, audio_asd) for the prompt model; the
        ``lam`` task's unused streams are the JAX package's zero
        placeholders."""
        frames = batch["frames"]
        if task == "lam":
            zeros = lambda *shape: frames.new_zeros((frames.shape[0], *shape),
                                                   dtype=torch.float32)
            return frames, zeros(1, 112, 112), zeros(4), zeros(4, 13)
        if task == "ttm":
            return (frames, batch["video_asd"], batch["audio"],
                    batch["audio_asd"])
        return frames, batch["faces"], batch["audio"], batch["mfcc"]

    @staticmethod
    def _decode_target(task, batch):
        """The task's target sequences, (B', 3); ASD's per frame,
        (B*T, 3)."""
        tgt = batch["target_seq"].long()
        return tgt.reshape(-1, tgt.shape[-1]) if task == "asd" else tgt

    def train_step(self, state, batches, generator):
        """One Adam step on the sum of the three tasks' teacher-forced
        losses, from a train-mode forward whose dropout masks
        ``generator`` draws."""
        model = set_dropout_generator(state.model.train(), generator)
        total = 0.0
        for task in TASKS:
            tgt = self._decode_target(task, batches[task])
            logits = model(*self._task_args(task, batches[task]),
                           tgt[:, :-1], task)
            total = total + seq_ce(logits, tgt[:, 1:])
        state.apply_loss(total)
        return state, {"loss": total.detach()}

    def eval_step(self, state, batches) -> Dict[str, torch.Tensor]:
        """Per task: ``{task}`` the greedy logits over '0' and '1', (B',
        2), and ``{task}_loss`` the teacher-forced loss, from one
        encoding."""
        model = state.model.eval()
        out = {}
        with torch.no_grad():
            for task in TASKS:
                encoded = model.encode(*self._task_args(task, batches[task]),
                                       task)
                out[task] = model.first_token_logits(encoded, task)
                tgt = self._decode_target(task, batches[task])
                out[f"{task}_loss"] = seq_ce(model.decode(tgt[:, :-1],
                                                          encoded),
                                             tgt[:, 1:])
        return out

    # -- validation aggregation (host side) -------------------------------
    def start_validation(self):
        return {"correct": defaultdict(int), "total": defaultdict(int),
                "loss": [], "map": defaultdict(list)}

    def accumulate(self, ctx, outputs, batches):
        for task in TASKS:
            logits = _host(outputs[task]).astype(np.float32)
            labels = _host(batches[task]["target_seq"]).reshape(-1, 3)[:, 1]
            # the label tokens '0' and '1' are the vocabulary's last two
            label01 = labels - (len(self.vocab) - 2)
            pred = logits.argmax(axis=-1)
            ctx["correct"][task] += int((pred == label01).sum())
            ctx["total"][task] += len(pred)
            if task in ("lam", "ttm"):
                scores = np.exp(logits[:, 1]) / np.exp(logits).sum(axis=1)
                ctx["map"][task].extend(
                    (int(y), float(s)) for y, s in zip(label01, scores))
            ctx["loss"].append(float(outputs[f"{task}_loss"]))

    def finalize_validation(self, ctx) -> Dict[str, float]:
        out = {"val_loss": float(np.mean(ctx["loss"])) if ctx["loss"]
               else 0.0}
        for task in TASKS:
            out[f"val_{task}_acc"] = (ctx["correct"][task]
                                      / max(ctx["total"][task], 1))
        for task in ("lam", "ttm"):
            rows = ctx["map"][task]
            if rows:
                # every row is a sample of its own: positional uids
                labels, scores = zip(*rows)
                uids = [f"{task}{i}" for i in range(len(rows))]
                out[f"val_{task}_mAP"], _ = run_evaluation(
                    uids, np.asarray(labels), np.asarray(scores))
        return out


class Unified3Task(Unified3TaskTranslation):
    """The single-stream baseline (``TaskPromptTransformer``)."""

    model_name = "TaskPromptTransformer"
