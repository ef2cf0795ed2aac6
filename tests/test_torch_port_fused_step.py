"""The port's conformer ASR step and decode with both opt-in routes on (the
LayerNorm kernels and the fused prenet core) against the JAX package's, on
the CPU.

A small conformer ARASRNet with the conformer-small recipe's structure
(``recipes/asr/librispeech/train-clean-5/exp_cfg/bpe1k_conformer-small.
yaml``) at D = C = 128 (the narrowest width both routes' gates accept),
2 heads of 64, F = 256, K = 31, 2 conformer + 1 decoder layers, 16 mel
bins. The JAX side runs with ``SPEECHAIN_FORCE_FUSED_LN=1`` and
``SPEECHAIN_FORCE_FUSED_PRENET=pallas`` beside the variables that force
its other Pallas paths, all in interpret mode; the port takes the routes
from its config (``fused_ln=True``, ``prenet_core="fused"``). The batch
(4 utterances, T_enc 24, 8 decoder positions) gives 96 encoder and 32
decoder rows, multiples of 8, so both sides route every encoder and
decoder LayerNorm to the kernel (the decoder's ``emb_layernorm`` stays
flax's / plain on both). Both take three steps through their public entry
points (JAX's ``make_arasr_step(axis_name=None)``; the port's with
``device="cpu"``), float32, dropout 0, no SpecAugment; then both decode
two waveforms at beam 4 with the trained variables.

Tolerances (float32, same rounding points, sums in another order): losses
1e-5 relative; the first step's gradients within 1e-5 of the largest
gradient entry; parameters and running statistics after each step within
1e-5 of each array's largest magnitude; hypotheses token-equal, scores
within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.infer.asr import make_asr_decoder as jdecoder
from speechain_tpu.models.ar_asr import ARASRConfig as JConfig
from speechain_tpu.models.ar_asr import ARASRNet as JNet
from speechain_tpu.models.ar_asr import arasr_loss as jloss
from speechain_tpu.ops.feat_norm import FeatNormConfig as JFN
from speechain_tpu.ops.frontend import FrontendConfig as JFE
from speechain_tpu.train.optim import build_optimizer as jbuild
from speechain_tpu.train.state import init_train_state as jinit
from speechain_tpu.train.state import make_arasr_step as jmake
from speechain_tpu_torch.infer.asr import make_asr_decoder
from speechain_tpu_torch.models.ar_asr import ARASRConfig, ARASRNet
from speechain_tpu_torch.models.ar_asr import arasr_loss
from speechain_tpu_torch.ops.dropout import step_rng
from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
from speechain_tpu_torch.ops.frontend import FrontendConfig
from speechain_tpu_torch.train.optim import build_optimizer
from speechain_tpu_torch.train.state import init_train_state, make_arasr_step
from speechain_tpu_torch.utils.weights import from_flax_variables

V, D, L, B, STEPS = 23, 128, 16000, 4, 3
OPT = dict(optim_conf=dict(lr=2e-3, betas=(0.9, 0.98), eps=1e-9),
           warmup_steps=25000)
FORCE = {"SPEECHAIN_FORCE_FLASH_ATT": "1",
         "SPEECHAIN_FORCE_FUSED_CONVMOD": "1",
         "SPEECHAIN_FORCE_FUSED_FFN": "1",
         "SPEECHAIN_FORCE_FUSED_LN": "1",
         "SPEECHAIN_FORCE_FUSED_PRENET": "pallas"}


def _cfg_kwargs():
    drop = dict(att_dropout=0.0, fdfwd_dropout=0.0, res_dropout=0.0,
                posenc_dropout=0.0)
    return dict(
        vocab_size=V,
        enc_prenet=dict(conv_dims=[D, D], conv_kernel=3, conv_stride=2,
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
    rng = np.random.default_rng(41)
    text = rng.integers(1, V - 1, (B, 9)).astype(np.int32)
    text[:, 0] = V - 1
    return dict(
        feat=(0.1 * rng.standard_normal((B, L, 1))).astype(np.float32),
        feat_len=np.array([L, L - 4000, L - 7000, L - 2500], np.int32),
        text=text, text_len=np.array([9, 6, 4, 8], np.int32))


def _waves():
    rng = np.random.default_rng(42)
    wave = (0.1 * rng.standard_normal((2, L, 1))).astype(np.float32)
    return wave, np.array([L, L - 2345], np.int32)


DECODE = dict(beam_size=4, eos_filtering=True, eos_threshold=1.5,
              max_len=8)


@pytest.fixture(scope="module")
def runs():
    batch = _batch()
    wave, wave_len = _waves()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("SPEECHAIN_DISABLE_PALLAS", raising=False)
        mp.delenv("SPEECHAIN_DISABLE_FUSED_PRENET", raising=False)
        for var, value in FORCE.items():
            mp.setenv(var, value)
        jcfg = JConfig(frontend=JFE(n_mels=16, preemphasis=0.97),
                       feat_norm=JFN(feat_dim=16), **_cfg_kwargs())
        jnet = JNet(cfg=jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        shapes = jax.eval_shape(
            jnet.init, {"params": jax.random.PRNGKey(0)},
            *[jb[k] for k in ("feat", "feat_len", "text", "text_len")])
        variables = _random_tree(shapes, seed=16)
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
            jafter.append(jax.tree_util.tree_map(
                np.asarray, {"params": jstate.params, **jstate.mutables}))
        jout = jdecoder(jnet, **DECODE)(
            jax.tree_util.tree_map(jnp.asarray, jafter[-1]),
            jnp.asarray(wave), jnp.asarray(wave_len))
        jout = {k: np.asarray(v) for k, v in jout.items()}

    tcfg = ARASRConfig(frontend=FrontendConfig(n_mels=16, preemphasis=0.97),
                       feat_norm=FeatNormConfig(feat_dim=16), fused_ln=True,
                       prenet_core="fused", **_cfg_kwargs())
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
    dnet = ARASRNet(tcfg)
    dnet.load_state_dict(from_flax_variables(jafter[-1]), strict=True)
    tout = make_asr_decoder(dnet, device="cpu", **DECODE)(
        torch.from_numpy(wave), torch.from_numpy(wave_len))
    return dict(jlosses=jlosses, tlosses=tlosses, jgrads=jgrads,
                tgrads=tgrads, jafter=jafter, tafter=tafter, tnet=tnet,
                jout=jout, tout=tout)


def test_fused_routes_are_taken(runs):
    net = runs["tnet"]
    assert net.enc_prenet.fused_route(101, 16) == "fused"
    lns = [m for n, m in net.named_modules() if n.endswith("layernorm")]
    fused = [m for m in lns if m.fused]
    # 4 per conformer layer + final, 3 per decoder layer + final; the
    # decoder's emb_layernorm stays plain
    assert len(fused) == 2 * 4 + 1 + 1 * 3 + 1
    assert not net.decoder.posenc.emb_layernorm.fused


def test_fused_step_losses_match_jax(runs):
    np.testing.assert_allclose(runs["tlosses"], runs["jlosses"], rtol=1e-5)
    assert all(np.isfinite(runs["jlosses"]))


def test_fused_step_gradients_match_jax(runs):
    want = from_flax_variables({"params": runs["jgrads"]})
    got = runs["tgrads"]
    assert sorted(want) == sorted(got)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)
    for name in ("enc_prenet.conv_0.weight", "enc_prenet.batchnorm_0.weight",
                 "enc_prenet.conv_1.weight",
                 "encoder.layer_0.mha_layernorm.weight"):
        assert float(want[name].abs().max()) > 1e-4 * scale, name


@pytest.mark.parametrize("step", range(STEPS))
def test_fused_params_and_statistics_match_jax_after_each_step(runs, step):
    want = from_flax_variables(runs["jafter"][step])
    got = runs["tafter"][step]
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        if w.dtype == torch.bool:
            assert torch.equal(g, w), name
            continue
        err = float((g.float() - w).abs().max())
        assert err <= 1e-5 * max(float(w.abs().max()), 1e-6), (name, err)


def test_fused_decode_matches_jax(runs):
    j, t = runs["jout"], runs["tout"]
    np.testing.assert_array_equal(t["hypo_text"].numpy(), j["hypo_text"])
    np.testing.assert_allclose(t["hypo_text_confid"].numpy(),
                               j["hypo_text_confid"], atol=1e-4, rtol=0)
