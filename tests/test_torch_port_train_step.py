"""The port's whole ASR training step against the JAX package's, on the CPU.

A tiny transformer-encoder ARASRNet (the structure of the
transformer-wide recipe at D = 32, 2 + 2 layers) starts from the same
seeded variables on both sides (bridged with ``from_flax_variables``);
both take three steps on the same numpy batch through their public entry
points: JAX's ``make_arasr_step(axis_name=None)`` and the port's
``init_train_state`` / ``build_optimizer`` / ``make_arasr_step`` with
``device="cpu"``. float32, dropout 0 and no SpecAugment, so no random
draw enters either side. The batch has a row with ``text_len`` 1 (empty
decoder target, fully masked self-attention) and one with ``text_len`` 0.
The optimizer is the recipe's (Noam, peak 2e-3, warmup 16000, Adam
(0.9, 0.98), eps 1e-9, clip 5): its first rates are tiny, so the params
move by ~lr * sign(g) and float32 noise in near-zero gradients stays
invisible.

Tolerances: losses 1e-4 relative; parameters and running statistics
within 1e-4 of each array's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.models.ar_asr import ARASRConfig as JConfig
from speechain_tpu.models.ar_asr import ARASRNet as JNet
from speechain_tpu.ops.feat_norm import FeatNormConfig as JFN
from speechain_tpu.ops.frontend import FrontendConfig as JFE
from speechain_tpu.train.optim import build_optimizer as jbuild
from speechain_tpu.train.state import init_train_state as jinit
from speechain_tpu.train.state import make_arasr_step as jmake
from speechain_tpu_torch.models.ar_asr import ARASRConfig, ARASRNet
from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
from speechain_tpu_torch.ops.frontend import FrontendConfig
from speechain_tpu_torch.train.optim import build_optimizer
from speechain_tpu_torch.train.state import init_train_state, make_arasr_step
from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               to_flax_variables)

V, D, L, B = 23, 32, 8000, 4
OPT = dict(optim_conf=dict(lr=2e-3, betas=(0.9, 0.98), eps=1e-9),
           warmup_steps=16000, grad_clip=5.0)


def _cfg_kwargs():
    drop = dict(att_dropout=0.0, fdfwd_dropout=0.0, res_dropout=0.0,
                posenc_dropout=0.0)
    return dict(
        vocab_size=V,
        enc_prenet=dict(conv_dims=[8, 8], conv_kernel=3, conv_stride=2,
                        conv_batchnorm=True, conv_activation="LeakyReLU",
                        lnr_dims=D),
        encoder_type="transformer",
        encoder=dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
                     fdfwd_activation="GELU", **drop),
        dec_emb=dict(embedding_dim=D),
        decoder=dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
                     fdfwd_activation="GELU", emb_layernorm=True,
                     emb_scale=False, **drop),
        ctc_weight=0.3, label_smoothing=0.2)


def _random_tree(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", getattr(path[-1], "name", "")))
        if x.dtype == bool:
            return np.zeros(x.shape, bool)      # feature norm: unseen
        if name in ("var",):
            v = rng.uniform(0.5, 1.5, x.shape)
        elif name in ("std", "aver_std"):
            v = np.ones(x.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(x.shape)
        elif name in ("kernel", "embedding"):
            fan_in = int(np.prod(x.shape[:-1])) if name == "kernel" else 1
            v = rng.standard_normal(x.shape) / np.sqrt(fan_in)
        elif name in ("batch", "mean", "aver_mean"):
            v = np.zeros(x.shape)
        else:
            v = 0.1 * rng.standard_normal(x.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _batch():
    rng = np.random.default_rng(21)
    text = rng.integers(1, V - 1, (B, 9)).astype(np.int32)
    text[:, 0] = V - 1
    return dict(
        feat=(0.1 * rng.standard_normal((B, L, 1))).astype(np.float32),
        feat_len=np.array([L, L - 1500, L - 400, L - 3000], np.int32),
        text=text, text_len=np.array([9, 6, 1, 0], np.int32))


@pytest.fixture(scope="module")
def runs():
    jcfg = JConfig(frontend=JFE(n_mels=16, preemphasis=0.97),
                   feat_norm=JFN(feat_dim=16), **_cfg_kwargs())
    jnet = JNet(cfg=jcfg)
    batch = _batch()
    shapes = jax.eval_shape(
        jnet.init, {"params": jax.random.PRNGKey(0)},
        *[jnp.asarray(batch[k]) for k in ("feat", "feat_len", "text",
                                          "text_len")])
    variables = _random_tree(shapes, seed=5)

    jtx = jbuild(**OPT)
    jstate = jinit(jax.tree_util.tree_map(jnp.asarray, variables), jtx)
    jstep = jax.jit(jmake(jnet, jcfg, jtx, axis_name=None))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses = []
    for i in range(3):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        jlosses.append(float(m["loss"]))
    jvars = {"params": jstate.params, **jstate.mutables}

    tcfg = ARASRConfig(frontend=FrontendConfig(n_mels=16, preemphasis=0.97),
                       feat_norm=FeatNormConfig(feat_dim=16),
                       **_cfg_kwargs())
    tnet = ARASRNet(tcfg)
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    ttx = build_optimizer(**OPT)
    tstate = init_train_state(tnet, ttx, device="cpu")
    tstep = make_arasr_step(tnet, tcfg, ttx, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    tlosses = []
    for _ in range(3):
        tstate, m = tstep(tstate, tbatch, gen)
        tlosses.append(float(m["loss"]))
    return (jlosses, jax.tree_util.tree_map(np.asarray, jvars), tlosses,
            tstate, variables)


def test_three_step_losses_match_jax(runs):
    jlosses, _, tlosses, tstate, _ = runs
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert int(tstate.step) == 3
    assert all(np.isfinite(jlosses))


def test_three_step_params_and_statistics_match_jax(runs):
    _, jvars, _, tstate, _ = runs
    want = from_flax_variables(jvars)
    got = tstate.net.state_dict()
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name].detach()
        if w.dtype == torch.bool:
            assert torch.equal(g, w), name
            continue
        err = float((g.float() - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-6), (name, err)


def test_step_moved_params_and_stats(runs):
    """Three steps changed the weights, the BatchNorm statistics and the
    feature-norm statistics (the comparison above is not vacuous)."""
    _, _, _, tstate, variables = runs
    sd = tstate.net.state_dict()
    start = from_flax_variables(variables)
    assert float(sd["frontend.stats.batch"][0]) == 3.0
    assert bool(sd["frontend.stats.seen"][0])
    for name in ("encoder.layer_0.feed_forward.in_layer.weight",
                 "enc_prenet.batchnorm_1.running_mean", "ctc_head.linear.bias",
                 "encoder.layer_1.multihead_att.q_layer.weight"):
        assert not torch.equal(sd[name], start[name]), name


def test_weight_bridge_round_trip_transformer(runs):
    """to_flax_variables inverts from_flax_variables over the transformer
    encoder, the CTC head, the decoder's embedding LayerNorm and the
    prenet's batch_stats."""
    _, _, _, _, variables = runs
    back = to_flax_variables(from_flax_variables(variables))
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = {tuple(str(getattr(p, "key", p)) for p in k): v
           for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert len(got) == len(want)
    for path, leaf in want:
        key = tuple(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)
        np.testing.assert_array_equal(got[key], np.asarray(leaf),
                                      err_msg=str(key))
    assert ("params", "ctc_head", "linear", "kernel") in got
    assert ("batch_stats", "enc_prenet", "batchnorm_0", "mean") in got


def test_eval_step_leaves_state_byte_identical(runs):
    _, _, _, tstate, _ = runs
    tcfg = ARASRConfig(frontend=FrontendConfig(n_mels=16, preemphasis=0.97),
                       feat_norm=FeatNormConfig(feat_dim=16),
                       **_cfg_kwargs())
    before = {k: v.clone() for k, v in tstate.net.state_dict().items()}
    step = make_arasr_step(tstate.net, tcfg, build_optimizer(**OPT),
                           train=False, device="cpu")
    st, m = step(tstate, {k: torch.from_numpy(v)
                          for k, v in _batch().items()},
                 torch.Generator().manual_seed(1))
    assert torch.isfinite(m["loss"])
    assert int(st.step) == int(tstate.step)
    for k, v in st.net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_training_entry_point_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    net = ARASRNet(ARASRConfig(frontend=FrontendConfig(n_mels=16),
                               **_cfg_kwargs()))
    tx = build_optimizer(**OPT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_arasr_step(net, net.cfg, tx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(net, tx)
