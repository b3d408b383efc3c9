"""The port's Stage-I building blocks against the JAX package's.

``egot2x_torch`` against ``egot2x`` on the CPU, f32, at toy sizes, the
same inputs drawn from numpy seeds:

  * training-mode BatchNorm (``nn/layers.py``) against
    ``flax.linen.BatchNorm(use_running_average=False)``: the output and
    the running mean and variance after two updates, at flax momentum 0.9
    and 0.99 (torch's 0.1 and 0.01), and at 4 values a channel, where
    torch's own update (the unbiased variance) misses; rtol 1e-5. Eval
    mode is torch's own BN bit for bit;
  * the BiLSTM (``nn/lstm.py``, torch's LSTM) against ``egot2x``'s scan,
    weights through the bridge: output and the gradients of the input and
    every weight, rtol 1e-5 (atol 1e-6 on the gradients);
  * ``audio/melspec.py::resse_frontend`` and ``nn/resnet_se.py::ResNetSE``,
    in eval and in training mode (with its BN statistics after the step);
  * the ASD task's learning rate over 5 steps against
    ``optax.exponential_decay`` (rtol 1e-7);
  * TalkNet's dropout sites and rate, eval mode bit for bit the inference
    path, masks from the generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from flax import linen as fnn  # noqa: E402

from egot2x.audio.melspec import resse_frontend as jax_frontend  # noqa: E402
from egot2x.nn.lstm import BiLSTM as JaxBiLSTM  # noqa: E402
from egot2x.nn.resnet_se import ResNetSE as JaxResNetSE  # noqa: E402
from egot2x_torch.audio.melspec import resse_frontend  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.config import Config  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.nn.common import Dropout, set_dropout_generator  # noqa: E402
from egot2x_torch.nn.layers import BatchNorm1d, BatchNorm2d  # noqa: E402
from egot2x_torch.nn.lstm import BiLSTM  # noqa: E402
from egot2x_torch.nn.resnet_se import ResNetSE  # noqa: E402
from egot2x_torch.tasks.asd import ActiveSpeakerDetection  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401


def _nchw_to_nhwc(x):
    return np.moveaxis(x, 1, -1)


@pytest.mark.parametrize("momentum,shape", [
    (0.9, (4, 3, 5, 6)), (0.99, (4, 3, 5, 6)), (0.9, (4, 6))],
    ids=["m0.9", "m0.99", "4-values-a-channel"])
def test_train_batchnorm_matches_flax(momentum, shape):
    """Two training-mode updates on two batches from near-(0, 1) running
    statistics: each output and the running statistics after both."""
    rng = np.random.default_rng(0)
    c = shape[1]
    eps = 1e-3 if momentum == 0.99 else 1e-5
    xs = [(rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
          for _ in range(2)]
    scale = rng.uniform(0.8, 1.2, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.05).astype(np.float32)
    mean = (rng.standard_normal(c) * 0.05).astype(np.float32)
    var = rng.uniform(0.8, 1.2, c).astype(np.float32)

    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                            epsilon=eps)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    cls = BatchNorm2d if len(shape) == 4 else BatchNorm1d
    bn = cls(c, eps=eps, momentum=1.0 - momentum).train()
    stock = (torch.nn.BatchNorm2d if len(shape) == 4 else
             torch.nn.BatchNorm1d)(c, eps=eps, momentum=1.0 - momentum)
    with torch.no_grad():
        for m in (bn, stock):
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
            m.running_mean.copy_(torch.from_numpy(mean))
            m.running_var.copy_(torch.from_numpy(var))
    apply = jax.jit(lambda v, x: flax_bn.apply(v, x,
                                               mutable=["batch_stats"]))
    for x in xs:
        want, mutated = apply(variables, _nchw_to_nhwc(x))
        variables = {"params": variables["params"], **mutated}
        got = bn(torch.from_numpy(x))
        stock(torch.from_numpy(x))
        np.testing.assert_allclose(_nchw_to_nhwc(got.detach().numpy()),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-5)
    if shape == (4, 6):
        # torch's update takes the unbiased variance: it misses flax's
        assert not np.allclose(stock.running_var.numpy(), stats["var"],
                               rtol=1e-2)
    x = torch.from_numpy(xs[0])
    bn.eval()
    stock.load_state_dict(bn.state_dict())
    assert torch.equal(bn(x), stock.eval()(x))


def test_bilstm_matches_jax():
    """Output and every gradient of a 2-layer BiLSTM, hidden 32."""
    rng = np.random.default_rng(1)
    hidden = 32
    x = rng.standard_normal((2, 7, hidden)).astype(np.float32)
    cot = rng.standard_normal((2, 7, 2 * hidden)).astype(np.float32)
    port = BiLSTM(hidden)
    variables = bridge.random_jax_variables(port, 2)
    bridge.load_jax_variables(port, variables)
    jax_lstm = JaxBiLSTM(hidden, num_layers=2)

    def loss(params, x):
        return jnp.sum(jax_lstm.apply({"params": params}, x) * cot)

    want = jax.jit(lambda p, x: jax_lstm.apply({"params": p}, x))(
        variables["params"], x)
    dparams, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables["params"], x)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-5,
                               atol=1e-6)
    grads = bridge.to_jax_variables(_with_grads(port))["params"]
    for layer, leaves in dparams.items():
        for name, g in leaves.items():
            np.testing.assert_allclose(grads[layer][name], np.asarray(g),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{layer}/{name}")


def _with_grads(model):
    """A copy of ``model`` whose parameters are its gradients."""
    import copy

    shadow = copy.deepcopy(model)
    with torch.no_grad():
        for (n, p), q in zip(shadow.named_parameters(), model.parameters()):
            p.copy_(q.grad)
    return shadow


def _wave(seed, n=2, samples=8000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, samples)) * 0.1).astype(np.float32)


def test_resse_frontend_matches_jax():
    """Normalized log-mels of 0.5 s of audio, (2, 64, 51)."""
    wave = _wave(3)
    want = np.asarray(jax.jit(jax_frontend)(wave))
    got = resse_frontend(torch.from_numpy(wave))
    assert got.shape == want.shape == (2, 64, 51)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def resnet_se():
    port = ResNetSE()
    variables = bridge.random_jax_variables(port, 4)
    bridge.load_jax_variables(port, variables)
    return port, variables, JaxResNetSE()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_se_matches_jax(resnet_se, train):
    """The 512-d embedding of raw audio; in training mode also the BN
    running statistics after the step (attention BN over B*T')."""
    port, variables, jax_model = resnet_se
    wave = _wave(5)
    port.train(train)
    try:
        got = port(torch.from_numpy(wave))
        stats = bridge.to_jax_variables(port)["batch_stats"]
        bridge.load_jax_variables(port, variables)
    finally:
        port.eval()
    if train:
        want, mutated = jax.jit(lambda v, w: jax_model.apply(
            v, w, train=True, mutable=["batch_stats"]))(variables, wave)
        for path, leaf in _flat(mutated["batch_stats"]).items():
            np.testing.assert_allclose(_flat(stats)[path], leaf, rtol=1e-4,
                                       atol=1e-5, err_msg=path)
    else:
        want = jax.jit(lambda v, w: jax_model.apply(v, w))(variables, wave)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def test_asd_lr_decay_matches_optax():
    """The learning rate of each of 5 steps: lr * decay ** k, as optax's
    ``exponential_decay(lr, 1, decay)`` counts; no decay at 1.0."""
    lr, decay = 1e-4, 0.95
    task = ActiveSpeakerDetection(Config(lr=lr, lr_decay=decay),
                                  device="cpu")
    state = task.build_state(0)
    schedule = optax.exponential_decay(lr, transition_steps=1,
                                       decay_rate=decay)
    for k in range(5):
        got = state.optimizer.param_groups[0]["lr"]
        np.testing.assert_allclose(got, float(schedule(k)), rtol=1e-7)
        state.optimizer.step()
        state.scheduler.step()
    flat = ActiveSpeakerDetection(Config(lr=lr), device="cpu").build_state(0)
    assert flat.scheduler is None
    assert "scheduler" in state.state_dict()


@pytest.fixture(scope="module")
def talknet():
    model = build_model("TalkNetWithHeads", device="cpu")
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, 6))
    rng = np.random.default_rng(7)
    inputs = (torch.from_numpy(rng.standard_normal((2, 60, 13)).astype(
        np.float32)), torch.from_numpy(rng.uniform(0, 255, (
            2, 15, 40, 40)).astype(np.float32)))
    return model, inputs


def test_talknet_dropout_sites_and_rate(talknet):
    """Rate 0.1 on each attention layer's probabilities, attention output,
    FFN hidden layer and FFN output; nowhere else."""
    model, _ = talknet
    rates = {n: m.p for n, m in model.named_modules()
             if isinstance(m, Dropout)}
    want = {f"model.{layer}.{site}": 0.1
            for layer in ("crossA2V", "crossV2A", "selfAV")
            for site in ("self_attn.dropout", "dropout", "dropout1",
                         "dropout2")}
    assert rates == want


def test_talknet_dropout_in_eval_and_from_the_generator(talknet):
    """Eval mode after training mode is the inference path bit for bit
    (BN on running statistics, no dropout); in training mode the masks
    come from the generator, not the global RNG."""
    model, inputs = talknet
    with torch.no_grad():
        reference = model.eval()(*inputs)["logits_av"]
        state = {k: v.clone() for k, v in model.state_dict().items()}
        rng_state = torch.get_rng_state()
        try:
            draw = lambda s: set_dropout_generator(
                model.train(), torch.Generator().manual_seed(s))(
                    *inputs)["logits_av"]
            first, again, other = draw(0), draw(0), draw(1)
        finally:
            model.load_state_dict(state)   # the BN statistics moved
            set_dropout_generator(model.eval(), None)
        assert torch.equal(torch.get_rng_state(), rng_state)
        assert torch.equal(model(*inputs)["logits_av"], reference)
    assert torch.equal(first, again)
    assert not torch.allclose(first, other, rtol=1e-3, atol=1e-3)
