"""The port's EgoT2-g HHI prompt translators against the JAX package.

``egot2x_torch`` attention with ``mask`` and ``is_causal``, the post-LN
``TransformerDecoder``, the HHI vocabulary, ``CombinedLoader`` and the
prompt model ``TaskTranslationPromptTransformer`` against ``egot2x``'s
(tests/test_torch_port_egot2g_baseline.py runs the model tests on
``TaskPromptTransformer``), at small widths (hidden
32, 4 heads, 1 layer, 2 for the decoder, vocab 7; B=2 clips of T=3 frames
of 32^2 RGB). The same weights (the port's seeded tree through the weight
bridge, JAX layout) and the same numpy inputs go through both, f32 on the
CPU; the JAX side's tree shape comes from an abstract ``init``
(``jax.eval_shape``) and each JAX apply is jitted.

Tolerances: attention and the decoder (eval, and its cross-attention
weights) rtol = atol = 1e-5; the prompt models' teacher-forced and
``predict`` logits on all three tasks rtol = atol = 1e-4, as the
flagship's (tests/test_torch_port_slice.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.translate.egot2g  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.core.torch_import import (egot2g_hhi_rules,  # noqa: E402
                                      partial_match_load, tree_paths)
from egot2x.data.combined import CombinedLoader as JaxCombined  # noqa: E402
from egot2x.nn.common import TransformerDecoder as JaxDecoder  # noqa: E402
from egot2x.ops.attention import (  # noqa: E402
    dot_product_attention as jax_attention)
from egot2x.translate.egot2g import (  # noqa: E402
    HHI_G_FROZEN_KEYS as FROZEN)
from egot2x.translate.egot2g import (  # noqa: E402
    TaskTranslationPromptTransformer as JaxTranslation)
from egot2x.translate.vocab import build_hhi_vocab as jax_vocab  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.data.combined import CombinedLoader  # noqa: E402
from egot2x_torch.nn.common import TransformerDecoder  # noqa: E402
from egot2x_torch.ops import attention, flash  # noqa: E402
from egot2x_torch.translate.egot2g import _HHIPromptBase  # noqa: E402
from egot2x_torch.translate.vocab import build_hhi_vocab  # noqa: E402
from test_torch_port_train import (_one_thread,  # noqa: E402,F401
                                   trunks_traced_once)

V, D, HEADS, LAYERS = 7, 32, 4, 1
B, T, IMG = 2, 3, 32
TASKS = ("lam", "ttm", "asd")
TOL = dict(rtol=1e-4, atol=1e-4)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- attention -------------------------------------------------------------
def _attention_case(case):
    """q (2, t, 4, 8), k and v (2, s, 4, 8), and the mask and causal flag
    of ``case``; ``masked_rows`` drops every key of query 1 in batch 0,
    head 2 (and of query 0 in batch 1, all heads)."""
    t, s = (5, 7) if case != "causal_t_gt_s" else (7, 5)
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _f32(rng, 2, t, 4, 8), _f32(rng, 2, s, 4, 8), _f32(rng, 2, s,
                                                                 4, 8)
    mask, causal = None, case.startswith("causal")
    if case in ("mask_heads", "mask_causal", "masked_rows"):
        mask = rng.uniform(size=(2, 4, t, s)) > 0.3
        mask[..., 0] = True   # no row dropped whole by chance
        if case == "masked_rows":
            mask[0, 2, 1] = False
            mask[1, :, 0] = False
        causal = case == "mask_causal"
    elif case == "mask_broadcast":
        mask = rng.uniform(size=(2, 1, t, s)) > 0.4
        mask[..., 0] = True
    return q, k, v, mask, causal


@pytest.mark.parametrize("case", ["mask_heads", "mask_broadcast",
                                  "causal_t_lt_s", "causal_t_gt_s",
                                  "mask_causal", "masked_rows"])
def test_attention_with_mask_and_causal_matches_jax(case):
    """Masks of (B, H, T, S) and (B, 1, T, S), causal with T != S either
    way, both, and fully masked rows (zeros on both sides)."""
    q, k, v, mask, causal = _attention_case(case)
    want = np.asarray(jax.jit(
        lambda *a: jax_attention(*a[:3], mask=a[3], is_causal=causal))(
            q, k, v, mask))
    got = attention.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal).numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)
    if case == "masked_rows":
        assert not got[0, 1, 2].any() and not got[1, 0].any()


def test_attention_dropout_path_keeps_fully_masked_rows_nan():
    """The explicit (dropout) path applies the mask and causal masks as
    the plain path does and, as the JAX package's, does not zero a fully
    masked row."""
    q, k, v, mask, _ = _attention_case("masked_rows")
    args = [torch.from_numpy(x) for x in (q, k, v)]
    m = torch.from_numpy(mask)
    plain = attention.dot_product_attention(*args, mask=m, is_causal=True)
    explicit = attention.dot_product_attention(
        *args, mask=m, is_causal=True, probs_dropout=lambda p: p)
    nan = torch.isnan(explicit)
    assert nan[0, 1, 2].all() and nan[1, 0].all()
    assert nan.sum() == 8 + 4 * 8
    torch.testing.assert_close(explicit[~nan], plain[~nan], rtol=0, atol=0)


def test_masked_and_causal_attention_never_route_to_flash(monkeypatch):
    """With the route forced open, unmasked attention takes the flash
    wrapper (its plain version on the CPU) and masked or causal attention
    does not."""
    calls = []
    kernel = flash.flash_attention
    monkeypatch.setattr(attention, "routes_to_flash", lambda *a: True)
    monkeypatch.setattr(flash, "flash_attention",
                        lambda *a: calls.append(1) or kernel(*a))
    q, k, v, mask, _ = _attention_case("mask_heads")
    args = [torch.from_numpy(x) for x in (q, k, v)]
    attention.dot_product_attention(*args, mask=torch.from_numpy(mask))
    attention.dot_product_attention(*args, is_causal=True)
    assert calls == []
    attention.dot_product_attention(*args)
    assert calls == [1]


# -- the decoder -----------------------------------------------------------
@pytest.mark.parametrize("layers, weights, masks", [
    (1, False, False), (2, True, False), (2, True, True)],
    ids=["1_layer", "2_layers_weights", "2_layers_masks"])
def test_decoder_matches_jax(layers, weights, masks):
    """The causal post-LN decoder in eval (4 target tokens over 6 memory
    tokens, FFN 64), with the last layer's cross-attention weights and
    with a target and a memory mask."""
    rng = np.random.default_rng(layers * 10 + masks)
    tgt, memory = _f32(rng, 2, 4, D), _f32(rng, 2, 6, D)
    tgt_mask = rng.uniform(size=(2, 1, 4, 4)) > 0.3 if masks else None
    memory_mask = rng.uniform(size=(2, HEADS, 4, 6)) > 0.3 if masks else None
    if masks:
        tgt_mask[..., 0] = memory_mask[..., 0] = True
    port = TransformerDecoder(layers, D, HEADS, dim_feedforward=64).eval()
    variables = bridge.random_jax_variables(port, seed=layers)
    bridge.load_jax_variables(port, variables)
    jax_model = JaxDecoder(layers, D, HEADS, dim_feedforward=64)
    want = jax.jit(lambda v, *a: jax_model.apply(
        v, *a, return_weights=weights))(
            {"params": variables["params"]}, tgt, memory, tgt_mask,
            memory_mask)
    t = lambda x: None if x is None else torch.from_numpy(x)
    with torch.no_grad():
        got = port(t(tgt), t(memory), t(tgt_mask), t(memory_mask),
                   return_weights=weights)
    if weights:
        (got, got_w), (want, want_w) = got, want
        assert got_w.shape == (2, 4, 6)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                                   **MODULE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


# -- the vocabulary and the combined loader -------------------------------
def test_hhi_vocab_layout_matches_jax():
    ours, theirs = build_hhi_vocab(), jax_vocab()
    assert ours.itos == theirs.itos == ["</s>", "<unk>", "ttm", "lam", "asd",
                                        "0", "1"]
    assert ours.stoi == theirs.stoi and len(ours) == V
    assert ours["nope"] == theirs["nope"] == 1
    assert _HHIPromptBase.TASK_IDS == JaxTranslation.TASK_IDS == {
        task: ours[task] for task in TASKS}


class _Loader(list):
    """A loader of numbered batches that records ``set_epoch``."""

    epoch = None

    def set_epoch(self, epoch):
        self.epoch = epoch


def test_combined_loader_cycles_as_jax_does():
    """max_size_cycle: the longest loader sets the length, the shorter
    ones start again; ``set_epoch`` reaches every loader that has it."""
    make = lambda: {"lam": _Loader(range(5)), "ttm": _Loader(range(2)),
                    "asd": list(range(3))}
    ours, theirs = CombinedLoader(make()), JaxCombined(make())
    assert len(ours) == len(theirs) == 5
    assert list(ours) == list(theirs) == list(ours)
    assert [b["ttm"] for b in ours] == [0, 1, 0, 1, 0]
    ours.set_epoch(3)
    assert ours.loaders["lam"].epoch == ours.loaders["ttm"].epoch == 3


# -- the prompt models -----------------------------------------------------
def _inputs(seed):
    rng = np.random.default_rng(seed)
    streams = dict(
        video=_f32(rng, B, T, IMG, IMG, 3),
        video_asd=rng.uniform(0, 255, (B, T, 112, 112)).astype(np.float32),
        audio=np.zeros((B, T * 16000 // 30), np.float32),
        audio_asd=_f32(rng, B, 4 * T, 13))
    targets = {task: rng.integers(0, V, (B * T if task == "asd" else B, 2))
               for task in TASKS}
    return streams, targets


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(out.get(k), dict) else v
    return out


def _structure(tree):
    return sorted((jax.tree_util.keystr(p), np.shape(v)) for p, v in
                  jax.tree_util.tree_leaves_with_path(tree))


@pytest.fixture(scope="module")
def model_name():
    """The prompt model under test (tests/test_torch_port_egot2g_baseline.py
    overrides it)."""
    return "TaskTranslationPromptTransformer"


@pytest.fixture(scope="module")
def prompt(model_name):
    """(name, JAX model, the shapes of its variables over the three tasks'
    inits, port model, shared variables)."""
    name = model_name
    model = jax_build(name, vocab_size=V, hidden_dim=D, num_heads=HEADS,
                      num_layers=LAYERS)
    streams, targets = _inputs(0)
    init = {}
    # a task's call builds only the branches it runs; the translation
    # model's ttm call runs them all
    for task in TASKS if name == "TaskPromptTransformer" else ("ttm",):
        init = _merge(init, jax.eval_shape(
            lambda *a: model.init(jax.random.key(0), *a, task, train=False),
            *map(jnp.asarray, streams.values()), jnp.asarray(targets[task])))
    port = build_model(name, device="cpu", vocab_size=V, hidden_dim=D,
                       num_heads=HEADS, num_layers=LAYERS)
    variables = bridge.random_jax_variables(port, seed=3)
    bridge.load_jax_variables(port, variables)
    return name, model, init, port, variables


def test_random_variables_have_the_jax_tree_structure(prompt):
    _, _, init, _, variables = prompt
    for coll in ("params", "batch_stats"):
        assert _structure(variables[coll]) == _structure(init[coll])


def test_bridge_round_trips(prompt):
    """JAX tree -> port -> JAX tree and port -> JAX tree -> port, leaf for
    leaf."""
    _, _, _, port, variables = prompt
    back = bridge._flatten(bridge.to_jax_variables(port))
    for path, leaf in bridge._flatten(variables).items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))
    state = bridge.from_jax_variables(port, bridge.to_jax_variables(port))
    for key, value in port.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(state[key], value), key


def test_port_names_load_through_jax_torch_import(prompt):
    """The port's state_dict -> the JAX package's egot2g_hhi_rules +
    partial_match_load (the reference checkpoints' path) -> the same JAX
    tree."""
    _, _, init, port, variables = prompt
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    translated = partial_match_load(state, egot2g_hhi_rules(LAYERS),
                                    tree_paths(init))
    assert [k for k in translated["unused"]
            if not k.endswith("num_batches_tracked")] == []
    for coll in ("params", "batch_stats"):
        got = bridge._flatten(translated[coll])
        want = bridge._flatten(variables[coll])
        assert sorted(got) == sorted(want)
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf)


@pytest.fixture(scope="module")
def logits(prompt):
    """Each task's teacher-forced and ``predict`` logits from both
    packages: one jitted JAX function for the six."""
    _, model, _, port, variables = prompt
    streams, targets = _inputs(1)

    @jax.jit
    @functools.partial(trunks_traced_once, names=FROZEN)
    def run(v, s, tg):
        out = {}
        for task in TASKS:
            out[task] = model.apply(v, *s, tg[task], task, train=False)
            out[task + "_predict"] = model.apply(v, *s, task,
                                                 method="predict")
        return out

    want = run(variables, tuple(streams.values()), targets)
    x = [torch.from_numpy(a) for a in streams.values()]
    got = {}
    with torch.no_grad():
        for task in TASKS:
            got[task] = port(*x, torch.from_numpy(targets[task]), task)
            got[task + "_predict"] = port.predict(*x, task)
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("task", TASKS)
def test_forward_logits_match_jax(logits, task):
    got, want = logits
    rows = B * T if task == "asd" else B
    assert got[task].shape == want[task].shape == (rows, 2, V)
    np.testing.assert_allclose(got[task].numpy(), want[task], **TOL)


@pytest.mark.parametrize("task", TASKS)
def test_predict_logits_match_jax(logits, task):
    got, want = logits
    key = task + "_predict"
    rows = B * T if task == "asd" else B
    assert got[key].shape == want[key].shape == (rows, 2)
    np.testing.assert_allclose(got[key].numpy(), want[key], **TOL)


def test_lam_task_runs_the_lam_trunk_only(prompt):
    """The ``lam`` task encodes the LAM stream alone: the other trunks'
    placeholders are never read."""
    _, _, _, port, _ = prompt
    streams, _ = _inputs(2)
    x = [torch.from_numpy(a) for a in streams.values()]
    want = port.predict(*x, "lam")
    got = port.predict(x[0], None, None, None, "lam")
    assert torch.equal(got, want)


def test_prompt_encoder_routes_to_flash_unmasked_only(prompt, monkeypatch):
    """With the route opened at 9 tokens, the ASD request's encoder (3T = 9
    tokens for the translation model, T = 3 for the baseline) takes the
    flash wrapper once a layer and the causal decoder and its
    cross-attention (1 query) never do; the logits stay the same."""
    name, _, _, port, _ = prompt
    streams, _ = _inputs(3)
    x = [torch.from_numpy(a) for a in streams.values()]
    want = port.predict(*x, "asd")
    calls = []
    kernel = flash.flash_attention
    monkeypatch.setattr(attention, "routes_to_flash",
                        lambda d, t, s: t >= 9 and s >= 9)
    monkeypatch.setattr(flash, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or kernel(*a))
    got = port.predict(*x, "asd")
    routed = name == "TaskTranslationPromptTransformer"
    assert calls == ([(B, 3 * T, HEADS, D // HEADS)] * LAYERS if routed
                     else [])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
