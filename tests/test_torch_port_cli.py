"""The port's CLIs on the CPU (``--device cpu``).

Each CLI runs with ``--synthetic --fast_dev_run --device cpu`` and returns
finite metrics, at toy widths where the CLI has the flags (1 layer, hidden
32) and 15-frame batches. A CLI writes its ``--synthetic`` tree only where
none is (``data/synthetic.py``'s writers); the module writes small ones
first (one short TTM segment and one ASD track a video, 8 LAM frames),
so that every batch is one item of the smallest bucket (EgoT2-g's
repeats it to its 30-frame budget) and the tests cost seconds;
``run_multitask`` runs its single-encoding ``--task unified`` here (the
translation encodes each task's batch once more). ``run_ttm --two_loader``
(the flagship's Stage-II command) at toy widths trains one epoch on such
a tree, writes a checkpoint, and ``--eval --ckpt`` restores the trained
weights and gives back the same metrics; ``run_asd --two_loader`` and
both ``run_multitask`` tasks run on the card in ``chip_smoke.py``. The
CLIs the port does not have, the models it does not have, tensor
parallelism, and a run with no card and no ``--device`` raise by name.
"""

import math
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

from egot2x_torch.cli import run_asd, run_lam, run_multitask  # noqa: E402
from egot2x_torch.cli import run_ttm  # noqa: E402
from egot2x_torch.data import synthetic  # noqa: E402
from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader  # noqa: E402
from egot2x_torch.train.trainer import Trainer  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

TOY = ["--num_layers", "1", "--hidden_dim", "32"]
RUNS = {
    "ttm": (run_ttm, ["--batch_size", "15", "--img_size", "32"]),
    "ttm_two_task": (run_ttm, ["--model", "TaskFusionMFTransformer2Task",
                               "--batch_size", "15", "--img_size", "32",
                               *TOY]),
    "lam": (run_lam, ["--img_size", "32", "--precise_bn_batches", "1"]),
    "asd": (run_asd, ["--batch_size", "15"]),
    "multitask": (run_multitask, ["--task", "unified", *TOY]),
}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A temporary directory for the CLIs' ``--synthetic`` trees (under
    the temporary directory), small ones written first, and their
    ``logs/``."""
    root = tmp_path_factory.mktemp("cli")
    cwd, tmp = os.getcwd(), tempfile.tempdir
    os.chdir(root)
    tempfile.tempdir = str(root)
    synthetic.make_lam_fixture(synthetic.fixture_root("lam"), n_frames=8,
                               img_size=16, device="cpu")
    synthetic.make_ttm_fixture(synthetic.fixture_root("ttm"), img_size=16,
                               seg_lens=[16], device="cpu")
    synthetic.make_asd_fixture(synthetic.fixture_root("asd"), n_tracks=1,
                               img_size=48, device="cpu")
    yield root
    os.chdir(cwd)
    tempfile.tempdir = tmp


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cli_fast_dev_run(workdir, run):
    module, args = RUNS[run]
    metrics = module.main(["--synthetic", "--fast_dev_run", "--device",
                           "cpu", *args])
    assert metrics and all(math.isfinite(v) for v in metrics.values())


def test_ttm_two_loader_checkpoint_round_trip(workdir, monkeypatch):
    """One epoch (one segment, one step), its checkpoint, and ``--eval
    --ckpt`` on it: the trained weights restored over the seeded ones
    (which the step moved), and the same validation metrics."""
    seeded, validated = [], []

    def trainable(state):
        return {k: p.detach().clone() for k, p in
                state.model.named_parameters() if p.requires_grad}

    build_state, validate = TalkingToMe2Loader.build_state, Trainer.validate

    def seed_spy(self, seed=0):
        state = build_state(self, seed)
        seeded.append(trainable(state))
        return state

    def validate_spy(self, state, loader):
        validated.append(trainable(state))
        return validate(self, state, loader)

    monkeypatch.setattr(TalkingToMe2Loader, "build_state", seed_spy)
    monkeypatch.setattr(Trainer, "validate", validate_spy)
    args = ["--two_loader", "--model", "TaskFusionMFTransformer3Task",
            "--data_root", synthetic.fixture_root("ttm"), "--batch_size",
            "15", "--img_size", "32", "--num_workers", "2", "--device",
            "cpu", "--output_dir", "round_trip", *TOY]
    trained = run_ttm.main([*args, "--epochs", "1"])
    ckpt = os.path.join("logs", "ttm", "round_trip", "checkpoints")
    assert os.path.exists(os.path.join(ckpt, "epoch_0.pt"))
    assert run_ttm.main([*args, "--eval", "--ckpt", ckpt]) == trained
    first, restored = seeded[0], validated[-1]
    assert restored.keys() == validated[-2].keys() == first.keys()
    assert all(torch.equal(restored[k], validated[-2][k]) for k in first)
    assert not all(torch.equal(restored[k], first[k]) for k in first)


def test_what_is_not_ported_raises_by_name(workdir):
    with pytest.raises(NotImplementedError, match="pnr_train"):
        from egot2x_torch.cli import pnr_train  # noqa: F401
    with pytest.raises(NotImplementedError,
                       match="TaskFusionMFTransformer3TaskDropout"):
        run_ttm.main(["--model", "TaskFusionMFTransformer3TaskDropout",
                      "--synthetic",
                      "--fast_dev_run", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="model_parallel"):
        run_lam.main(["--model_parallel", "--synthetic", "--fast_dev_run",
                      "--device", "cpu"])
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_lam.main(["--synthetic", "--fast_dev_run"])
