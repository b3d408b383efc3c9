"""What the CLIs share: the device flag and the fit-or-evaluate tail."""

from __future__ import annotations

import argparse
from typing import Dict, Optional


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' or 'cuda:N' (default: the current card) or "
                        "'cpu' (the plain path, for tests)")


def fit_or_evaluate(task, trainer, args,
                    resume_from: Optional[str] = None) -> Dict[str, float]:
    """``--eval``: validate the seeded state, or ``--ckpt``'s last
    checkpoint; else train, then validate. Prints and returns the
    metrics."""
    from egot2x_torch.train.trainer import CheckpointManager

    if args.eval:
        state = task.build_state(args.seed)
        if args.ckpt:
            state = CheckpointManager(args.ckpt, task.checkpoint_metric,
                                      task.checkpoint_mode).restore(state)
    else:
        state = trainer.fit(task.train_loader(), task.val_loader(),
                            resume_from=resume_from)
    metrics = trainer.validate(state, task.val_loader())
    print({k: round(float(v), 4) for k, v in metrics.items()})
    return metrics
