"""HHI EgoT2-g entry point: the JAX package's ``egot2x/cli/run_multitask.py``
flags and defaults (the reference's HHI/scripts/run_multitask.py):
``--task translation`` trains ``Unified3TaskTranslation``, ``--task
unified`` the single-encoding ``Unified3Task`` baseline, on the three HHI
tasks' combined loaders; ``--synthetic`` writes the three fixture trees on
the device; ``--fast_dev_run``; plus ``--device``.

Usage:
  python -m egot2x_torch.cli.run_multitask --synthetic --fast_dev_run
"""

from __future__ import annotations

import argparse
import os

from egot2x_torch.cli.common import add_device_flag


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Ego4D HHI EgoT2-g "
                                            "(egot2x_torch)")
    p.add_argument("--task", type=str, default="translation",
                   choices=["translation", "unified"])
    p.add_argument("--lam_root", type=str, default="../data/lam")
    p.add_argument("--ttm_root", type=str, default="../data/ttm")
    p.add_argument("--asd_root", type=str, default="../data/asd")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--lam_checkpoint", type=str, default=None)
    p.add_argument("--ttm_checkpoint", type=str, default=None)
    p.add_argument("--asd_checkpoint", type=str, default=None)
    p.add_argument("--fast_dev_run", action="store_true")
    p.add_argument("--output_dir", type=str, default="debug")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--lam_batch", type=int, default=4)
    p.add_argument("--synthetic", action="store_true")
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from egot2x_torch.core.config import Config
    from egot2x_torch.core.registry import resolve_device
    from egot2x_torch.tasks.multitask_hhi import (Unified3Task,
                                                  Unified3TaskTranslation)
    from egot2x_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    if args.synthetic:
        from egot2x_torch.data import synthetic

        args.lam_root, args.ttm_root, args.asd_root = (
            synthetic.fixture_root(t) for t in ("lam", "ttm", "asd"))
        if not os.path.exists(os.path.join(args.lam_root, "train.list")):
            synthetic.make_lam_fixture(args.lam_root, img_size=32,
                                       device=device)
        if not os.path.exists(os.path.join(args.ttm_root, "train.list")):
            synthetic.make_ttm_fixture(args.ttm_root, img_size=32,
                                       device=device)
        if not os.path.exists(os.path.join(args.asd_root, "csv",
                                           "active_speaker_train.csv")):
            synthetic.make_asd_fixture(args.asd_root, img_size=48,
                                       device=device)
        args.img_size = 64
        args.num_workers = 2
        args.lam_batch = 2
    task_cls = (Unified3TaskTranslation if args.task == "translation"
                else Unified3Task)
    task = task_cls(Config(vars(args)), device=device)
    trainer = Trainer(task, max_epochs=args.epochs,
                      fast_dev_run=args.fast_dev_run,
                      default_root_dir=os.path.join("logs", "multitask_hhi",
                                                    args.output_dir),
                      seed=args.seed, device=device)
    state = trainer.fit(task.train_loader(), task.val_loader())
    metrics = trainer.validate(state, task.val_loader())
    print({k: round(float(v), 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
