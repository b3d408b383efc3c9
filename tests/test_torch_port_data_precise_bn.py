"""Precise BN in the port against the JAX package's.

``egot2x_torch/train/precise_bn.py::compute_precise_bn_stats`` on the
port's batch-statistics BatchNorm (``nn/layers.py``, flax's semantics)
against ``egot2x/train/precise_bn.py::compute_precise_bn_stats`` on flax's
BatchNorm at momentum 0.9 (the JAX package's ResNets', which its recovery
from the EMA update assumes), the same weights and batches: the means and
variances averaged over the batches to 1e-6. The JAX side's one jitted
forward is a Dense and a BatchNorm (under a second to compile). The
sub-batch aggregate equals the JAX package's; a model without BN is left
as it is, and the Trainer's hook runs only for tasks that give
``bn_forward_args``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.train.precise_bn import (  # noqa: E402
    aggregate_sub_batch_stats as jax_aggregate)
from egot2x.train.precise_bn import (  # noqa: E402
    compute_precise_bn_stats as jax_precise)
from egot2x_torch.nn.layers import BatchNorm1d, Linear  # noqa: E402
from egot2x_torch.train.precise_bn import (  # noqa: E402
    aggregate_sub_batch_stats, compute_precise_bn_stats)
from test_torch_port_train import _one_thread  # noqa: E402,F401

F_IN, F_OUT, N_BATCHES = 6, 5, 4


class _JaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Dense(F_OUT)(x)
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5)(x)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(F_IN, F_OUT)
        self.bn = BatchNorm1d(F_OUT, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return self.bn(self.fc(x))


def test_precise_bn_matches_jax():
    rng = np.random.default_rng(0)
    kernel = rng.standard_normal((F_IN, F_OUT)).astype(np.float32)
    bias = rng.standard_normal(F_OUT).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, F_OUT).astype(np.float32)
    offset = rng.standard_normal(F_OUT).astype(np.float32)
    mean0 = rng.standard_normal(F_OUT).astype(np.float32)
    var0 = rng.uniform(0.5, 2, F_OUT).astype(np.float32)
    batches = [(rng.standard_normal((16, F_IN)) * (1 + i)).astype(np.float32)
               for i in range(N_BATCHES + 1)]
    variables = {"params": {"Dense_0": {"kernel": kernel, "bias": bias},
                            "BatchNorm_0": {"scale": scale, "bias": offset}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0,
                                                 "var": var0}}}
    want = jax_precise(_JaxNet().apply, variables,
                       [(jnp.asarray(b),) for b in batches],
                       num_batches=N_BATCHES)["BatchNorm_0"]

    net = _Net().eval()
    with torch.no_grad():
        net.fc.weight.copy_(torch.from_numpy(kernel.T))
        net.fc.bias.copy_(torch.from_numpy(bias))
        net.bn.weight.copy_(torch.from_numpy(scale))
        net.bn.bias.copy_(torch.from_numpy(offset))
        net.bn.running_mean.copy_(torch.from_numpy(mean0))
        net.bn.running_var.copy_(torch.from_numpy(var0))
    n = compute_precise_bn_stats(
        net, [(torch.from_numpy(b),) for b in batches], N_BATCHES)
    assert n == N_BATCHES
    assert not net.training and net.bn.momentum == 0.1
    np.testing.assert_allclose(net.bn.running_mean.numpy(),
                               np.asarray(want["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(net.bn.running_var.numpy(),
                               np.asarray(want["var"]), rtol=1e-6, atol=1e-6)
    # the statistics are each batch's own: not an EMA of the old ones
    assert not np.allclose(net.bn.running_mean.numpy(), mean0)


def test_sub_batch_aggregate_and_no_bn():
    rng = np.random.default_rng(1)
    means, vars_ = rng.standard_normal((4, 3)), rng.uniform(0.5, 2, (4, 3))
    for ours, theirs in zip(aggregate_sub_batch_stats(means, vars_),
                            jax_aggregate(means, vars_)):
        np.testing.assert_array_equal(ours, theirs)
    fc = torch.nn.Linear(3, 2)
    assert compute_precise_bn_stats(fc, [(torch.zeros(2, 3),)]) == 0
