"""TTM entry point: the JAX package's ``egot2x/cli/run_ttm.py`` flags and
defaults (the reference's HHI/configs/ttm/config.py), with ``--two_loader``
for the Stage-II translators' four-stream feed (the flagship,
``TaskFusionMFTransformer3Task``, trains this way), the 2-task translator
on the plain feed, ``--nofreeze``, ``--remat``, ``--quant_trunks``,
``--eval --ckpt``, ``--synthetic`` (a fixture tree written on the device)
and ``--fast_dev_run``; plus ``--device``.

Usage:
  python -m egot2x_torch.cli.run_ttm --two_loader \\
      --model TaskFusionMFTransformer3Task --synthetic --fast_dev_run
"""

from __future__ import annotations

import argparse
import os

from egot2x_torch.cli import ported_model
from egot2x_torch.cli.common import add_device_flag, fit_or_evaluate

TWO_TASK_TRANSLATORS = {"TaskFusionMFTransformer2Task"}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Ego4D Talking to me "
                                            "(egot2x_torch)")
    p.add_argument("--data_root", type=str, default="../data/ttm")
    p.add_argument("--train_stride", type=int, default=3)
    p.add_argument("--val_stride", type=int, default=1)
    p.add_argument("--two_loader", action="store_true")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=400,
                   help="frames budget per batch (reference semantics)")
    p.add_argument("--num_workers", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--weights", type=float, nargs=2, default=[0.266, 0.734])
    p.add_argument("--fast_dev_run", action="store_true")
    p.add_argument("--exp_path", type=str, default="debug")
    p.add_argument("--output_dir", type=str, default="debug")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--submit", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", type=str, default="TTMBaselineLSTM")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--lam_checkpoint", type=str, default=None)
    p.add_argument("--ttm_checkpoint", type=str, default=None)
    p.add_argument("--asd_checkpoint", type=str, default=None)
    p.add_argument("--nofreeze", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute the backbones' activations in the "
                        "backward (nofreeze's memory saver)")
    p.add_argument("--quant_trunks", action="store_true",
                   help="run the frozen Stage-I trunks in int8 static PTQ "
                        "(scales calibrated on the first batch)")
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--hidden_dim2", type=int, default=512)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bf16"])
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from egot2x_torch.core.config import Config
    from egot2x_torch.core.registry import resolve_device
    from egot2x_torch.tasks.ttm import TalkingToMe
    from egot2x_torch.tasks.ttm_2loader import (TalkingToMe2Loader,
                                                TalkingToMe2Task)
    from egot2x_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    ported_model(args.model)
    if args.synthetic:
        from egot2x_torch.data.synthetic import fixture_root, make_ttm_fixture

        root = fixture_root("ttm")
        if not os.path.exists(os.path.join(root, "train.list")):
            make_ttm_fixture(root, img_size=32, device=device)
        args.data_root = root
        args.img_size = min(args.img_size, 64)
        args.batch_size = min(args.batch_size, 120)
        args.num_workers = 2
    if args.two_loader:
        task_cls = TalkingToMe2Loader
    elif args.model in TWO_TASK_TRANSLATORS:
        task_cls = TalkingToMe2Task
    else:
        task_cls = TalkingToMe
    task = task_cls(Config(vars(args)), device=device)
    trainer = Trainer(task, max_epochs=args.epochs,
                      fast_dev_run=args.fast_dev_run,
                      default_root_dir=os.path.join("logs", "ttm",
                                                    args.output_dir),
                      seed=args.seed, device=device)
    return fit_or_evaluate(task, trainer, args)


if __name__ == "__main__":
    main()
