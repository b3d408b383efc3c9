"""The port's flagship translator against the JAX package, end to end.

``egot2x_torch`` TaskFusionMFTransformer{3,2}Task and ``egot2x``'s, with
the same weights (numpy, JAX layout, through the weight bridge) and the
same inputs, at the golden shapes of tests/test_torch_import_egot2s_ttm.py
(B=2, T=4, IMG=64, D=64, 1 layer). Both run f32 on the CPU with full-
precision matmuls (the JAX side jitted, as it deploys), so the logits must agree to rtol = atol = 1e-4: ten
times tighter than the JAX package's own reference golden (rtol 1e-3,
atol 2e-3), which compares against a different implementation.

Also: the port's parameter names load into the JAX tree through the JAX
package's own ``egot2s_ttm_rules`` + ``partial_match_load``; the entry
point refuses to run without a card unless asked for the CPU; and no file
of the port imports JAX or the JAX package.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.translate.egot2s_hhi  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.core.torch_import import (egot2s_ttm_rules,  # noqa: E402
                                      partial_match_load, tree_paths)
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

D, HEADS, LAYERS = 64, 4, 1
B, T, IMG = 2, 4, 64
TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        video=rng.standard_normal((B, T, IMG, IMG, 3)).astype(np.float32),
        video_asd=rng.uniform(0, 255, (B, T, 112, 112)).astype(np.float32),
        audio=np.zeros((B, T * 16000 // 30), np.float32),
        audio_asd=rng.standard_normal((B, 4 * T, 13)).astype(np.float32))


def _structure(tree):
    return sorted((jax.tree_util.keystr(p), np.shape(v)) for p, v in
                  jax.tree_util.tree_leaves_with_path(tree))


@pytest.fixture(scope="module")
def flagship():
    """(JAX model, the shapes of its variables, port model, shared
    variables). The JAX tree's shapes come from an abstract init."""
    model = jax_build("TaskFusionMFTransformer3Task", hidden_dim=D,
                      num_heads=HEADS, num_layers=LAYERS)
    x = _inputs(0)
    init = jax.eval_shape(
        lambda *a: model.init(jax.random.key(0), *a, train=False),
        *map(jnp.asarray, x.values()))
    port = build_model("TaskFusionMFTransformer3Task", device="cpu",
                       hidden_dim=D, num_heads=HEADS, num_layers=LAYERS)
    variables = bridge.random_jax_variables(port, seed=1)
    bridge.load_jax_variables(port, variables)
    return model, init, port, variables


def test_random_variables_have_the_jax_tree_structure(flagship):
    _, init, _, variables = flagship
    for coll in ("params", "batch_stats"):
        assert _structure(variables[coll]) == _structure(init[coll])


def test_3task_logits_match_jax(flagship):
    model, _, port, variables = flagship
    x = _inputs(2)
    ours = np.asarray(jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
        variables, *map(jnp.asarray, x.values())))
    with torch.no_grad():
        theirs = port(*(torch.from_numpy(v) for v in x.values())).numpy()
    assert theirs.shape == ours.shape == (B, 2)
    np.testing.assert_allclose(theirs, ours, **TOL)


def test_3task_uint8_feed_matches_host_normalized(flagship):
    """The uint8 feeds (RGB normalized in-graph, grey normalized by
    TalkNet) give the logits of the host-normalized f32 feeds."""
    from egot2x_torch.data.lam import normalize_frames

    _, _, port, _ = flagship
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (B, T, IMG, IMG, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (B, T, 112, 112), dtype=np.uint8)
    mfcc = torch.from_numpy(rng.standard_normal((B, 4 * T, 13))
                            .astype(np.float32))
    with torch.no_grad():
        u8 = port(torch.from_numpy(rgb), torch.from_numpy(grey), None, mfcc)
        f32 = port(torch.from_numpy(normalize_frames(rgb)),
                   torch.from_numpy(grey.astype(np.float32)), None, mfcc)
    np.testing.assert_allclose(u8.numpy(), f32.numpy(), rtol=1e-5, atol=1e-5)


def test_port_names_load_through_jax_torch_import(flagship):
    """JAX variables -> bridge -> port state_dict -> the JAX package's
    egot2s_ttm_rules + partial_match_load -> the same JAX tree."""
    _, init, port, variables = flagship
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    translated = partial_match_load(state, egot2s_ttm_rules(3, LAYERS),
                                    tree_paths(init))
    leftovers = [k for k in translated["unused"]
                 if not k.endswith("num_batches_tracked")]
    assert leftovers == [], leftovers
    for coll in ("params", "batch_stats"):
        got = dict(jax.tree_util.tree_leaves_with_path(translated[coll]))
        want = dict(jax.tree_util.tree_leaves_with_path(variables[coll]))
        assert sorted(map(jax.tree_util.keystr, got)) == \
            sorted(map(jax.tree_util.keystr, want))
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf)


def test_2task_logits_match_jax():
    model = jax_build("TaskFusionMFTransformer2Task", hidden_dim=D,
                      num_heads=HEADS, num_layers=LAYERS)
    port = build_model("TaskFusionMFTransformer2Task", device="cpu",
                       hidden_dim=D, num_heads=HEADS, num_layers=LAYERS)
    variables = bridge.random_jax_variables(port, seed=4)
    bridge.load_jax_variables(port, variables)
    x = _inputs(5)
    ours = np.asarray(jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
        variables, jnp.asarray(x["video"]), jnp.asarray(x["audio"])))
    with torch.no_grad():
        theirs = port(torch.from_numpy(x["video"])).numpy()
    np.testing.assert_allclose(theirs, ours, **TOL)


def test_build_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("TaskFusionMFTransformer3Task")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_egot2x():
    files = sorted((ROOT / "egot2x_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"egot2x_torch/nn/quant.py", "egot2x_torch/nn/fused_stem.py",
            "egot2x_torch/nn/layers.py", "egot2x_torch/ops/int8.py",
            "egot2x_torch/ops/flash.py", "egot2x_torch/models/asd.py",
            "egot2x_torch/tasks/asd.py",
            "egot2x_torch/tasks/asd_2loader.py",
            "egot2x_torch/tools/ab_kernels.py",
            "egot2x_torch/ops/stem.py", "egot2x_torch/core/checkpoint.py",
            "egot2x_torch/tasks/ttm_2loader.py",
            "egot2x_torch/train/optim.py", "egot2x_torch/train/state.py",
            "egot2x_torch/tools/bench_train.py",
            "egot2x_torch/nn/lstm.py", "egot2x_torch/nn/resnet_se.py",
            "egot2x_torch/audio/melspec.py", "egot2x_torch/models/lam.py",
            "egot2x_torch/models/ttm.py", "egot2x_torch/tasks/lam.py",
            "egot2x_torch/tasks/ttm.py", "egot2x_torch/tasks/base.py",
            "egot2x_torch/translate/egot2g.py",
            "egot2x_torch/translate/vocab.py",
            "egot2x_torch/data/combined.py",
            "egot2x_torch/tasks/multitask_hhi.py"} <= names
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "egot2x")]
    assert bad == []
