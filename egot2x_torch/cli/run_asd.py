"""ASD entry point: the JAX package's ``egot2x/cli/run_asd.py`` flags and
defaults (the reference's HHI/configs/asd/config.py): TalkNet's Stage-I
training, or with ``--two_loader`` a Stage-II ASD translator
(``TaskFusionMFTransformer3TaskASD`` by default) behind the lossAV head;
``--resume``, ``--eval --ckpt``, ``--synthetic`` (a fixture tree written
on the device) and ``--fast_dev_run``; plus ``--device``.
``--init_from_ava`` and ``--finetune`` are taken and, as in the JAX
package, change nothing.

Usage:
  python -m egot2x_torch.cli.run_asd --synthetic --fast_dev_run
"""

from __future__ import annotations

import argparse
import os

from egot2x_torch.cli import ported_model
from egot2x_torch.cli.common import add_device_flag, fit_or_evaluate


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Ego4D Active Speaker Detection "
                                            "(egot2x_torch)")
    p.add_argument("--data_file_path", dest="data_root", type=str,
                   default="../data/asd")
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=2500,
                   help="frames budget per batch (TalkNet semantics)")
    p.add_argument("--num_workers", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_decay", type=float, default=0.95)
    p.add_argument("--fast_dev_run", action="store_true")
    p.add_argument("--exp_path", type=str, default="debug")
    p.add_argument("--output_dir", type=str, default="debug")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", type=str, default="TalkNetWithHeads")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--asd_checkpoint", type=str, default=None)
    p.add_argument("--init_from_ava", action="store_true")
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--two_loader", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from egot2x_torch.core.config import Config
    from egot2x_torch.core.registry import resolve_device
    from egot2x_torch.tasks.asd import ActiveSpeakerDetection
    from egot2x_torch.tasks.asd_2loader import ActiveSpeakerDetection2Loader
    from egot2x_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    if args.two_loader and args.model == "TalkNetWithHeads":
        args.model = "TaskFusionMFTransformer3TaskASD"
    ported_model(args.model)
    if args.synthetic:
        from egot2x_torch.data.synthetic import fixture_root, make_asd_fixture

        root = fixture_root("asd")
        if not os.path.exists(os.path.join(root, "csv",
                                           "active_speaker_train.csv")):
            make_asd_fixture(root, img_size=48, device=device)
        args.data_root = root
        args.batch_size = min(args.batch_size, 60)
        args.num_workers = 2
        if args.two_loader:
            args.rgb_size = 64
    task_cls = (ActiveSpeakerDetection2Loader if args.two_loader
                else ActiveSpeakerDetection)
    task = task_cls(Config(vars(args)), device=device)
    root = os.path.join("logs", "asd", args.output_dir)
    trainer = Trainer(task, max_epochs=args.epochs,
                      fast_dev_run=args.fast_dev_run, default_root_dir=root,
                      seed=args.seed, device=device)
    return fit_or_evaluate(task, trainer, args, resume_from=(
        os.path.join(root, "checkpoints") if args.resume else None))


if __name__ == "__main__":
    main()
