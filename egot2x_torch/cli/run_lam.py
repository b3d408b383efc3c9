"""LAM entry point: the JAX package's ``egot2x/cli/run_lam.py`` flags and
defaults (the reference's HHI/configs/lam/config.py), with
``--precise_bn_batches``, ``--resume``, ``--eval --ckpt``, ``--synthetic``
(a fixture tree written on the device) and ``--fast_dev_run``; plus
``--device``. ``--model_parallel`` (tensor parallelism over a mesh) has no
counterpart on one card and raises.

Usage:
  python -m egot2x_torch.cli.run_lam --model BaselineLSTM --synthetic --fast_dev_run
"""

from __future__ import annotations

import argparse
import os

from egot2x_torch.cli import ported_model
from egot2x_torch.cli.common import add_device_flag, fit_or_evaluate


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Ego4D Looking at me "
                                            "(egot2x_torch)")
    p.add_argument("--data_root", type=str, default="../data/lam")
    p.add_argument("--train_stride", type=int, default=13)
    p.add_argument("--val_stride", type=int, default=13)
    p.add_argument("--test_stride", type=int, default=1)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=10)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weights", type=float, nargs=2, default=[0.136, 0.864])
    p.add_argument("--fast_dev_run", action="store_true")
    p.add_argument("--exp_path", type=str, default="debug")
    p.add_argument("--output_dir", type=str, default="debug")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume training from the last checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", type=str, default="BaselineLSTM")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="generate + use a tiny synthetic fixture dataset")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bf16"])
    p.add_argument("--model_parallel", type=int, nargs="?", const=2,
                   default=0, help="not on one card: raises")
    p.add_argument("--precise_bn_batches", type=int, default=0,
                   help="recompute exact BN statistics over N train batches "
                        "before validation (reference BN.USE_PRECISE_STATS)")
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from egot2x_torch.core.config import Config
    from egot2x_torch.core.registry import resolve_device
    from egot2x_torch.tasks.lam import LookingAtMe
    from egot2x_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    ported_model(args.model)
    if args.model_parallel:
        raise NotImplementedError(
            "--model_parallel: the port runs one process on one card")
    if args.synthetic:
        from egot2x_torch.data.synthetic import fixture_root, make_lam_fixture

        root = fixture_root("lam")
        if not os.path.exists(os.path.join(root, "train.list")):
            make_lam_fixture(root, img_size=max(args.img_size // 2, 16),
                             device=device)
        args.data_root = root
        args.train_stride = args.val_stride = 1
        args.batch_size = min(args.batch_size, 4)
        args.img_size = min(args.img_size, 64)
        args.num_workers = 2
    task = LookingAtMe(Config(vars(args)), device=device)
    root = os.path.join("logs", "lam", args.output_dir)
    trainer = Trainer(task, max_epochs=args.epochs,
                      fast_dev_run=args.fast_dev_run, default_root_dir=root,
                      seed=args.seed, device=device,
                      precise_bn_batches=args.precise_bn_batches)
    return fit_or_evaluate(task, trainer, args, resume_from=(
        os.path.join(root, "checkpoints") if args.resume else None))


if __name__ == "__main__":
    main()
