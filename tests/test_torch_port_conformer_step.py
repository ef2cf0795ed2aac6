"""The port's whole conformer ASR training step against the JAX package's,
on the CPU.

A small conformer ARASRNet (the structure of the conformer-small recipe,
``recipes/asr/librispeech/train-clean-5/exp_cfg/bpe1k_conformer-small.yaml``,
at D = 128, 2 heads of 64, F = 256, K = 31, 2 conformer + 1 decoder
layers) starts from the same seeded variables on both sides (bridged with
``from_flax_variables``). The JAX package runs its Pallas paths (rel-pos
attention, conv module, FFN, flash attention) in interpret mode, forced
by the ``SPEECHAIN_FORCE_*`` variables. Both take three steps on the same
numpy batch through their public entry points: JAX's
``make_arasr_step(axis_name=None)`` and the port's ``init_train_state`` /
``build_optimizer`` / ``make_arasr_step`` with ``device="cpu"``. float32,
dropout 0 and no SpecAugment, so no random draw enters either side.
Ragged waveform lengths give T_enc 24 with shorter rows (padded frames
enter the conv modules' BatchNorm statistics, as in the reference). The
optimizer is the recipe's (Noam, peak 2e-3, warmup 25000, Adam (0.9,
0.98), eps 1e-9, clip 5).

Tolerances (float32, same rounding points, sums in another order):
losses 1e-5 relative; the gradient of the first step's loss within 1e-5
of the largest gradient entry of the whole network; parameters and
running statistics (feature norm, prenet and conv-module BatchNorm) after
each step within 1e-5 of each array's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.models.ar_asr import ARASRConfig as JConfig
from speechain_tpu.models.ar_asr import ARASRNet as JNet
from speechain_tpu.models.ar_asr import arasr_loss as jloss
from speechain_tpu.ops.feat_norm import FeatNormConfig as JFN
from speechain_tpu.ops.frontend import FrontendConfig as JFE
from speechain_tpu.train.optim import build_optimizer as jbuild
from speechain_tpu.train.state import init_train_state as jinit
from speechain_tpu.train.state import make_arasr_step as jmake
from speechain_tpu_torch.models.ar_asr import ARASRConfig, ARASRNet
from speechain_tpu_torch.models.ar_asr import arasr_loss
from speechain_tpu_torch.ops.dropout import step_rng
from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
from speechain_tpu_torch.ops.frontend import FrontendConfig
from speechain_tpu_torch.train.optim import build_optimizer
from speechain_tpu_torch.train.state import init_train_state, make_arasr_step
from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               to_flax_variables)

V, D, L, B, STEPS = 23, 128, 16000, 4, 3
OPT = dict(optim_conf=dict(lr=2e-3, betas=(0.9, 0.98), eps=1e-9),
           warmup_steps=25000)
FORCE = ("SPEECHAIN_FORCE_FLASH_ATT", "SPEECHAIN_FORCE_FUSED_CONVMOD",
         "SPEECHAIN_FORCE_FUSED_FFN")


def _cfg_kwargs():
    drop = dict(att_dropout=0.0, fdfwd_dropout=0.0, res_dropout=0.0,
                posenc_dropout=0.0)
    return dict(
        vocab_size=V,
        enc_prenet=dict(conv_dims=[8, 8], conv_kernel=3, conv_stride=2,
                        conv_batchnorm=True, conv_activation="LeakyReLU",
                        lnr_dims=D),
        encoder_type="conformer",
        encoder=dict(d_model=D, num_heads=2, num_layers=2, fdfwd_dim=256,
                     fdfwd_activation="GELU", depthwise_kernel_size=31,
                     layernorm_first=True, **drop),
        dec_emb=dict(embedding_dim=D),
        decoder=dict(d_model=D, num_heads=2, num_layers=1, fdfwd_dim=256,
                     fdfwd_activation="GELU", emb_layernorm=True,
                     emb_scale=False, layernorm_first=True, **drop),
        ctc_weight=0.3, label_smoothing=0.1)


def _random_tree(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", getattr(path[-1], "name", "")))
        if x.dtype == bool:
            return np.zeros(x.shape, bool)      # feature norm: unseen
        if name == "var":
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
    rng = np.random.default_rng(31)
    text = rng.integers(1, V - 1, (B, 9)).astype(np.int32)
    text[:, 0] = V - 1
    return dict(
        feat=(0.1 * rng.standard_normal((B, L, 1))).astype(np.float32),
        feat_len=np.array([L, L - 4000, L - 7000, L - 2500], np.int32),
        text=text, text_len=np.array([9, 6, 4, 8], np.int32))


@pytest.fixture(scope="module")
def runs():
    batch = _batch()
    with pytest.MonkeyPatch.context() as mp:
        for var in FORCE:
            mp.setenv(var, "1")
        jcfg = JConfig(frontend=JFE(n_mels=16, preemphasis=0.97),
                       feat_norm=JFN(feat_dim=16), **_cfg_kwargs())
        jnet = JNet(cfg=jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        shapes = jax.eval_shape(
            jnet.init, {"params": jax.random.PRNGKey(0)},
            *[jb[k] for k in ("feat", "feat_len", "text", "text_len")])
        variables = _random_tree(shapes, seed=6)
        jvars0 = jax.tree_util.tree_map(jnp.asarray, variables)

        def loss_of(params):
            out, _ = jnet.apply(
                {**jvars0, "params": params}, jb["feat"], jb["feat_len"],
                jb["text"], jb["text_len"], train=True,
                epoch=jnp.zeros((), jnp.int32), axis_name=None,
                rngs={"dropout": jax.random.PRNGKey(1),
                      "specaug": jax.random.PRNGKey(2)},
                mutable=["norm_stats", "batch_stats"])
            return jloss(out, jb["text"], jb["text_len"], jcfg)[0]

        jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
            loss_of))(jvars0["params"]))

        jtx = jbuild(**OPT)
        jstate = jinit(jvars0, jtx)
        jstep = jax.jit(jmake(jnet, jcfg, jtx, axis_name=None))
        jlosses, jafter = [], []
        for i in range(STEPS):
            jstate, m = jstep(jstate, jb, jax.random.PRNGKey(i))
            jlosses.append(float(m["loss"]))
            jafter.append(from_flax_variables(jax.tree_util.tree_map(
                np.asarray, {"params": jstate.params, **jstate.mutables})))

    tcfg = ARASRConfig(frontend=FrontendConfig(n_mels=16, preemphasis=0.97),
                       feat_norm=FeatNormConfig(feat_dim=16),
                       **_cfg_kwargs())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tnet = ARASRNet(tcfg)
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    with step_rng(torch.Generator().manual_seed(0)):
        out = tnet.train()(tb["feat"], tb["feat_len"], tb["text"],
                           tb["text_len"])
        loss, _ = arasr_loss(out, tb["text"], tb["text_len"], tcfg)
    names = [n for n, _ in tnet.named_parameters()]
    tgrads = dict(zip(names, torch.autograd.grad(loss,
                                                 list(tnet.parameters()))))

    tnet = ARASRNet(tcfg)
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    ttx = build_optimizer(**OPT)
    tstate = init_train_state(tnet, ttx, device="cpu")
    tstep = make_arasr_step(tnet, tcfg, ttx, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tlosses, tafter = [], []
    for _ in range(STEPS):
        tstate, m = tstep(tstate, tb, gen)
        tlosses.append(float(m["loss"]))
        tafter.append({k: v.detach().clone()
                       for k, v in tstate.net.state_dict().items()})
    return dict(jlosses=jlosses, tlosses=tlosses, jgrads=jgrads,
                tgrads=tgrads, jafter=jafter, tafter=tafter,
                variables=variables, tstate=tstate)


def test_conformer_step_losses_match_jax(runs):
    np.testing.assert_allclose(runs["tlosses"], runs["jlosses"], rtol=1e-5)
    assert int(runs["tstate"].step) == STEPS
    assert all(np.isfinite(runs["jlosses"]))


def test_conformer_step_gradients_match_jax(runs):
    want = from_flax_variables({"params": runs["jgrads"]})
    got = runs["tgrads"]
    assert sorted(want) == sorted(got)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)
    for name in ("encoder.layer_0.relpos_mha.pos_bias_u",
                 "encoder.layer_1.conv_module.depthwise_conv.weight",
                 "encoder.layer_0.conv_module.pointwise_conv1.weight"):
        assert float(want[name].abs().max()) > 1e-3 * scale, name


@pytest.mark.parametrize("step", range(STEPS))
def test_conformer_params_and_statistics_match_jax_after_each_step(runs,
                                                                   step):
    want, got = runs["jafter"][step], runs["tafter"][step]
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        if w.dtype == torch.bool:
            assert torch.equal(g, w), name
            continue
        err = float((g.float() - w).abs().max())
        assert err <= 1e-5 * max(float(w.abs().max()), 1e-6), (name, err)


def test_conformer_steps_moved_conv_batch_stats(runs):
    """Every conv module's BatchNorm running statistics moved at every
    step (so the comparison above is not vacuous), and they are bridged
    both ways by the weight bridge."""
    start = from_flax_variables(runs["variables"])
    stats = [n for n in start if ".conv_module.batch_norm.running_" in n]
    assert len(stats) == 4
    prev = start
    for after in runs["tafter"]:
        for n in stats:
            assert not torch.equal(after[n], prev[n]), n
        prev = after
    back = from_flax_variables(to_flax_variables(runs["tafter"][-1]))
    for n in stats:
        assert torch.equal(back[n], runs["tafter"][-1][n]), n
    tree = to_flax_variables(runs["tafter"][-1])
    assert set(tree["batch_stats"]["encoder"]["layer_1"]["conv_module"]
               ["batch_norm"]) == {"mean", "var"}
