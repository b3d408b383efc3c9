"""The port's command-line entry points, one module each:

  python -m egot2x_torch.cli.run_ttm [--two_loader] ...
  python -m egot2x_torch.cli.run_lam ...
  python -m egot2x_torch.cli.run_asd [--two_loader] ...
  python -m egot2x_torch.cli.run_multitask [--task translation|unified] ...

Each takes the JAX package's flags and defaults (``egot2x/cli/``) plus
``--device``, the card unless it says ``cpu``; without a card and without
``--device cpu`` it raises. One process drives one card: the JAX package's
multi-host start-up (``core/dist.py``) has no counterpart. The JAX
package's other CLIs are not ported yet, and importing one from here
raises by name.
"""

NOT_PORTED = ("import_ckpt", "multitask_run", "pnr_train", "preprocess",
              "run_lta", "run_sta", "submit")


def __getattr__(name):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"egot2x_torch.cli.{name}: the CLI {name} is not ported yet "
            "(ROADMAP.md §1)")
    raise AttributeError(name)


def ported_model(name: str) -> str:
    """``name`` when the port has that model, else NotImplementedError
    naming it."""
    from egot2x_torch.core.registry import MODEL_REGISTRY, register_models

    register_models()
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"--model {name}: this model is not ported to egot2x_torch yet "
            "(ROADMAP.md §1)")
    return name
