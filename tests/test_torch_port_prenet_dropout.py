"""The Conv2d prenet's ``conv_dropout`` and the linear prenet's
``lnr_dropout`` in the port, against the JAX package's modules on the CPU.

The reference drops after each conv block's activation step
(``speechain_tpu/nn/prenets.py:415-416``) and after each linear layer
(``:131-132``, ``LinearPrenet``, which ``Conv2dPrenet`` builds with its
``lnr_dropout``). In evaluation, and in training at rate 0, both packages
compute the same function (1e-5 of the largest value, float32). In
training the masks cannot agree bit for bit (flax draws threefry bits,
the port ``ops/dropout.py``'s mixer), so the law is compared: at rate 0.5
each dropout site zeroes a share within 4 sigma of 0.5 of its input and
scales what it keeps by exactly 1 / (1 - rate), and its input is the
activation's output (a Sigmoid's, all in (0, 1): so the zeros fall after
the activation), including a last block whose ReLU ``zero_centered``
skips. A set ``conv_dropout`` keeps both packages off the fused route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.nn.prenets import Conv2dPrenet as JConv2dPrenet
from speechain_tpu.nn.prenets import LinearPrenet as JLinearPrenet
from speechain_tpu.nn.prenets import _prenet_fused_impl
from speechain_tpu_torch.nn import prenets
from speechain_tpu_torch.nn.prenets import Conv2dPrenet, LinearPrenet
from speechain_tpu_torch.ops.dropout import step_rng
from speechain_tpu_torch.utils.weights import from_flax_variables

B, T, F, C = 3, 37, 21, 128
J = jnp.asarray
KEY = jax.random.PRNGKey(0)


def close(got, want, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (what, err)


def _randomize(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif name == "kernel":
            v = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        else:
            v = 0.1 * rng.standard_normal(x.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map(
        J, jax.tree_util.tree_map_with_path(leaf, variables))


def _conv_kw(rate, **over):
    kw = dict(conv_dims=[C, C], conv_kernel=3, conv_stride=2,
              conv_padding=0, conv_batchnorm=True,
              conv_activation="LeakyReLU", conv_dropout=rate,
              lnr_dims=[64, 32], lnr_activation="ReLU", lnr_dropout=rate)
    kw.update(over)
    return kw


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, T, F)).astype(np.float32)
    flen = np.array([T, T - 6, T - 11], np.int32)
    return feat, flen


@pytest.mark.parametrize("train,rate", [(False, 0.5), (True, 0.0)])
def test_conv2d_prenet_matches_jax_in_eval_and_at_rate_zero(train, rate):
    feat, flen = _inputs()
    kw = _conv_kw(rate)
    jmod = JConv2dPrenet(dtype=jnp.float32, **kw)
    v = _randomize(jax.eval_shape(jmod.init, KEY, J(feat), J(flen)), 3)
    (want, wlen), _ = jmod.apply(v, J(feat), J(flen), train=train,
                                 mutable=["batch_stats"])
    tmod = Conv2dPrenet(F, core=None, **kw)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    with step_rng(torch.Generator().manual_seed(0)):
        got, glen = tmod.train(train)(torch.from_numpy(feat),
                                      torch.from_numpy(flen))
    close(got, want, "out")
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))


@pytest.mark.parametrize("train,rate", [(False, 0.5), (True, 0.0)])
def test_linear_prenet_matches_jax_in_eval_and_at_rate_zero(train, rate):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 11, 48)).astype(np.float32)
    kw = dict(lnr_dims=[64, 32], lnr_activation="ReLU", lnr_dropout=rate)
    jmod = JLinearPrenet(dtype=jnp.float32, **kw)
    v = _randomize(jax.eval_shape(jmod.init, KEY, J(x)), 4)
    want, _ = jmod.apply(v, J(x), train=train)
    tmod = LinearPrenet(48, **kw)
    tmod.load_state_dict(from_flax_variables(v), strict=True)
    with step_rng(torch.Generator().manual_seed(0)):
        got = tmod.train(train)(torch.from_numpy(x))
    close(got, want, "out")


def _recorded_sites(monkeypatch):
    """Wrap the prenet module's dropout so each call records its input
    and output."""
    calls = []
    inner = prenets.dropout

    def spy(x, rate, training, seed=None):
        out = inner(x, rate, training, seed)
        calls.append((x.detach().clone(), out.detach().clone(), rate,
                      training))
        return out

    monkeypatch.setattr(prenets, "dropout", spy)
    return calls


def _assert_law(x, out, rate, positive_input):
    """out is 0 or exactly x / (1 - rate); the dropped share of the
    nonzero inputs lies within 4 sigma of rate."""
    x, out = x.double(), out.double()
    nz = x != 0
    dropped = (out == 0) & nz
    kept = ~dropped & nz
    assert torch.equal(out[kept], x[kept] / (1 - rate))
    n = int(nz.sum())
    share = int(dropped.sum()) / n
    assert abs(share - rate) <= 4 * np.sqrt(rate * (1 - rate) / n), (share,
                                                                     n)
    if positive_input:               # the activation's output: a Sigmoid
        assert bool((x > 0).all() and (x < 1).all())
    else:                            # ReLU skipped: negative inputs too
        assert bool((x < 0).any())


def test_training_drops_after_each_conv_block_and_linear_layer(monkeypatch):
    """Two conv blocks and two linear layers, Sigmoid activations, rate
    0.5: four dropout sites, each with the law, the conv blocks' over the
    channels-last layout; the same generator seed gives the same masks,
    another seed others."""
    calls = _recorded_sites(monkeypatch)
    feat, flen = _inputs(2)
    kw = _conv_kw(0.5, conv_activation="Sigmoid", lnr_activation="Sigmoid")
    tmod = Conv2dPrenet(F, core=None, **kw).train()
    from speechain_tpu_torch.utils.weights import random_state_dict
    tmod.load_state_dict(random_state_dict(tmod, seed=5))
    outs = []
    for seed in (7, 7, 8):
        calls.clear()
        with step_rng(torch.Generator().manual_seed(seed)):
            outs.append(tmod(torch.from_numpy(feat),
                             torch.from_numpy(flen))[0])
        assert len(calls) == 4
        for i, (x, out, rate, training) in enumerate(calls):
            assert rate == 0.5 and training
            if i < 2:                # (B, T_i, F_i, C): channels last
                assert x.shape[0] == B and x.shape[-1] == C
            _assert_law(x, out, rate, positive_input=True)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_zero_centered_last_block_still_drops(monkeypatch):
    """One conv block, no linear layers, ReLU skipped under zero_centered:
    the block still drops (the reference's dropout follows the activation
    step whether or not it ran)."""
    calls = _recorded_sites(monkeypatch)
    feat, flen = _inputs(3)
    kw = _conv_kw(0.5, conv_dims=[C], conv_activation="ReLU",
                  lnr_dims=None, lnr_dropout=None, zero_centered=True)
    tmod = Conv2dPrenet(F, core=None, **kw).train()
    from speechain_tpu_torch.utils.weights import random_state_dict
    tmod.load_state_dict(random_state_dict(tmod, seed=6))
    with step_rng(torch.Generator().manual_seed(1)):
        out, _ = tmod(torch.from_numpy(feat), torch.from_numpy(flen))
    assert len(calls) == 1
    x, dropped, rate, _ = calls[0]
    _assert_law(x, dropped, rate, positive_input=False)
    assert torch.equal(out.reshape(dropped.shape), dropped)


def test_evaluation_draws_nothing():
    """Outside a training step there is no generator; evaluation must not
    need one."""
    feat, flen = _inputs(4)
    tmod = Conv2dPrenet(F, core=None, **_conv_kw(0.5)).eval()
    out, _ = tmod(torch.from_numpy(feat), torch.from_numpy(flen))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("core", ["xla", "fused"])
def test_conv_dropout_refuses_the_fused_route(core, monkeypatch):
    """A set conv_dropout keeps both packages on the unfused route; a set
    lnr_dropout alone does not (the reference's gate reads only the conv
    rates), and the fused route then drops after its linear layers."""
    kw = _conv_kw(0.1)
    drops = [0.1, 0.1]
    monkeypatch.setenv("SPEECHAIN_FORCE_FUSED_PRENET",
                       "pallas" if core == "fused" else "xla")
    assert _prenet_fused_impl(kw["conv_dims"], (3, 3), (2, 2), (0, 0), True,
                              drops, "LeakyReLU", T, F) is None
    assert Conv2dPrenet(F, core=core, **kw).fused_route(T, F) is None
    kw = _conv_kw(None, lnr_dropout=0.5)
    assert _prenet_fused_impl(kw["conv_dims"], (3, 3), (2, 2), (0, 0), True,
                              [None, None], "LeakyReLU", T, F) is not None
    tmod = Conv2dPrenet(F, core=core, **kw).train()
    assert tmod.fused_route(T, F) == core
    calls = _recorded_sites(monkeypatch)
    feat, flen = _inputs(5)
    with step_rng(torch.Generator().manual_seed(2)):
        tmod(torch.from_numpy(feat), torch.from_numpy(flen))
    assert [c[2] for c in calls] == [0.5, 0.5]
