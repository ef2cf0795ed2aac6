"""The port's causal conformer (``uni_direction``, the streaming recipe's
offline training path), the rel-pos attention's full-mask route, and the
ASR internal-LM loss with attention guidance, against the JAX package on
the CPU.

- ``RelPosMultiHeadedAttention`` with a (B, T, T) mask (the causal band
  ANDed with a length mask, one row empty of keys beyond its first): the
  port's plain composition of the reference's XLA route, not the kernel
  (the kernel's wrapper must not be called), against JAX's module (which
  routes such masks to XLA), forward and gradients;
- the causal ``ConvolutionModule`` (left padding K - 1, BatchNorm over
  every position) in training: output, gradients and running statistics;
- a causal ``ConformerEncoder`` (2 layers, D 32, 4 heads, K 7): output
  and gradients in training mode, and causality (changing the frames
  after t leaves the output at every t' <= t unchanged);
- a small causal-conformer ARASRNet (1 + 1 layers on 16-dim features,
  CTC 0.3) with ``ilm_weight`` 0.3 and ``att_guid_sigma`` 0.2:
  ``arasr_loss`` and every metric, and the gradients of the loss in
  every parameter.

Seeded numpy values fill the JAX variables, bridged with
``from_flax_variables`` (strictly). float32, dropout 0. Tolerances:
outputs, losses and statistics 1e-5 of max(1, the largest magnitude);
gradients 1e-5 of the largest gradient entry of the whole module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.models.ar_asr import ARASRConfig as JConfig
from speechain_tpu.models.ar_asr import ARASRNet as JNet
from speechain_tpu.models.ar_asr import arasr_loss as jloss
from speechain_tpu.nn.attention import RelPosMultiHeadedAttention as JRelPos
from speechain_tpu.nn.conformer import ConformerEncoder as JEnc
from speechain_tpu.nn.conformer import ConvolutionModule as JConv
from speechain_tpu_torch.models.ar_asr import (ARASRConfig, ARASRNet,
                                               arasr_loss)
from speechain_tpu_torch.nn import attention as tattention
from speechain_tpu_torch.nn.conformer import (ConformerEncoder,
                                              ConvolutionModule)
from speechain_tpu_torch.ops.dropout import step_rng
from speechain_tpu_torch.utils.weights import from_flax_variables
from tests.test_torch_port_conformer_step import _random_tree
from tests.test_torch_port_tts_train import quick_jit

B, T, D, H, K = 3, 13, 32, 4, 7
DROP0 = dict(att_dropout=0.0, fdfwd_dropout=0.0, res_dropout=0.0,
             posenc_dropout=0.0)


def close(got, want, scale=None, tol=1e-5, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    s = scale if scale is not None else max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * s, (what, err, tol * s)


def _x(seed, shape=(B, T, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _lengths_mask(lens, causal=True):
    m = np.arange(T)[None, None, :] < np.asarray(lens)[:, None, None]
    if causal:
        m = m & np.tril(np.ones((T, T), bool))[None]
    return m


def _grads_close(want_tree, named_grads, what):
    """Port gradients (name -> tensor) against a JAX gradient tree,
    within 1e-5 of the largest gradient entry."""
    want = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, want_tree)})
    scale = max(float(w.abs().max()) for w in want.values())
    assert scale > 0
    assert sorted(want) == sorted(named_grads)
    for name, w in want.items():
        close(named_grads[name], w.numpy(), scale=scale,
              what=f"{what} {name}")


def test_relpos_full_mask_takes_the_composition_and_matches_jax(
        monkeypatch):
    """Causal band & lengths (6, 13, 1): the (B, T, T) mask is applied
    whole (the parent took its first query row as a key mask)."""
    x, pe = _x(1), _x(2, (1, 2 * T - 1, D))
    g = _x(3)
    mask = _lengths_mask([6, 13, 1])
    jm = JRelPos(d_model=D, num_heads=H, dropout=0.0)
    args = (jnp.asarray(x),) * 3 + (jnp.asarray(mask), jnp.asarray(pe))
    v = _random_tree(jm.init({"params": jax.random.PRNGKey(0)}, *args),
                     seed=4)

    def f(params, xj):
        out, _ = jm.apply({"params": params}, xj, xj, xj, args[3], args[4])
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx) = quick_jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], args[0])

    def no_kernel(*a, **k):
        raise AssertionError("a (B, T, T) mask reached the kernel route")
    monkeypatch.setattr(tattention, "cuda_relpos_attention", no_kernel)
    tm = tattention.RelPosMultiHeadedAttention(D, H, dropout=0.0)
    tm.load_state_dict(from_flax_variables(v), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt, torch.from_numpy(mask), torch.from_numpy(pe))
    close(out, jout, what="out")
    (out * torch.from_numpy(g)).sum().backward()
    close(xt.grad, jgx, what="dx")
    _grads_close(jgp, {n: p.grad for n, p in tm.named_parameters()}, "relpos")


def test_causal_conv_module_matches_jax():
    """Training mode: output, gradients of sum(out * g) and the
    BatchNorm running statistics."""
    x, g = _x(5), _x(6)
    jm = JConv(channels=D, depthwise_kernel_size=K, causal=True)
    v = _random_tree(jm.init({"params": jax.random.PRNGKey(0)},
                             jnp.asarray(x)), seed=7)

    def f(params, xj):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xj,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mut["batch_stats"])

    (_, (jout, jstats)), (jgp, jgx) = quick_jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    tm = ConvolutionModule(D, K, causal=True)
    tm.load_state_dict(from_flax_variables(v), strict=True)
    tm.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    close(out, jout, what="out")
    (out * torch.from_numpy(g)).sum().backward()
    close(xt.grad, jgx, what="dx")
    _grads_close(jgp, {n: p.grad for n, p in tm.named_parameters()}, "conv")
    close(tm.batch_norm.running_mean, jstats["batch_norm"]["mean"])
    close(tm.batch_norm.running_var, jstats["batch_norm"]["var"])


def _enc_kwargs():
    return dict(d_model=D, num_heads=H, num_layers=2, fdfwd_dim=64,
                depthwise_kernel_size=K, uni_direction=True, **DROP0)


def test_causal_encoder_matches_jax_and_is_causal():
    x, g = _x(8), _x(9)
    lens = np.array([13, 9, 4], np.int32)
    mask = _lengths_mask(lens, causal=False)
    jm = JEnc(**_enc_kwargs())
    v = _random_tree(jm.init({"params": jax.random.PRNGKey(0)},
                             jnp.asarray(x), jnp.asarray(mask)), seed=10)

    def f(params, xj):
        (out, omask, _, _), _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xj,
            jnp.asarray(mask), train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, omask)

    (_, (jout, jmask)), (jgp, jgx) = quick_jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    tm = ConformerEncoder(**_enc_kwargs())
    tm.load_state_dict(from_flax_variables(v), strict=True)
    tm.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out, omask = tm(xt, torch.from_numpy(mask))
    np.testing.assert_array_equal(omask.numpy(), np.asarray(jmask))
    close(out, jout, what="out")
    (out * torch.from_numpy(g)).sum().backward()
    close(xt.grad, jgx, what="dx")
    _grads_close(jgp, {n: p.grad for n, p in tm.named_parameters()}, "enc")

    tm.eval()                  # running statistics: rows independent
    with torch.no_grad():
        base, _ = tm(torch.from_numpy(x), torch.from_numpy(mask))
        for t in (0, 5, 11):
            moved = x.copy()
            moved[:, t + 1:] += _x(11 + t)[:, t + 1:]
            got, _ = tm(torch.from_numpy(moved), torch.from_numpy(mask))
            assert torch.equal(got[:, :t + 1], base[:, :t + 1]), t
            assert not torch.equal(got[0, t + 1:], base[0, t + 1:]), t


def _asr_kwargs():
    return dict(
        vocab_size=23, feat_norm=None,
        enc_prenet=dict(conv_dims=[8, 8], conv_kernel=3, conv_stride=2,
                        conv_batchnorm=True, conv_activation="ReLU",
                        lnr_dims=D),
        encoder_type="conformer",
        encoder=dict(d_model=D, num_heads=H, num_layers=1, fdfwd_dim=64,
                     depthwise_kernel_size=K, uni_direction=True, **DROP0),
        dec_emb=dict(embedding_dim=D),
        decoder=dict(d_model=D, num_heads=H, num_layers=1, fdfwd_dim=64,
                     **DROP0),
        ctc_weight=0.3, ilm_weight=0.3, att_guid_sigma=0.2,
        label_smoothing=0.1)


def test_ilm_and_attention_guidance_losses_match_jax():
    """The forward of a causal-conformer ARASRNet on 16-dim features,
    then arasr_loss (CE, CTC, ILM-CE, guidance on the first decoder
    layer's cross-attention): every metric and the loss's gradient in
    every parameter."""
    from speechain_tpu.ops.frontend import FrontendConfig as JFE
    from speechain_tpu_torch.ops.frontend import FrontendConfig
    rng = np.random.default_rng(12)
    feat = rng.standard_normal((3, 45, 16)).astype(np.float32)
    feat_len = np.array([45, 37, 30], np.int32)
    text = rng.integers(1, 22, (3, 8)).astype(np.int32)
    text[:, 0] = 22
    text_len = np.array([8, 6, 4], np.int32)
    for i, n in enumerate(text_len):
        text[i, n - 1], text[i, n:] = 22, 0
    jnet = JNet(cfg=JConfig(frontend=JFE(n_mels=16), **_asr_kwargs()))
    args = tuple(jnp.asarray(a) for a in (feat, feat_len, text, text_len))
    v = _random_tree(jax.eval_shape(jnet.init, {"params":
                                                jax.random.PRNGKey(0)},
                                    *args), seed=13)
    jcfg = jnet.cfg

    def f(params):
        out, _ = jnet.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, *args,
                            train=True, mutable=["batch_stats"])
        return jloss(out, args[2], args[3], jcfg)

    (_, jm), jg = quick_jit(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    tnet = ARASRNet(ARASRConfig(frontend=FrontendConfig(n_mels=16),
                                **_asr_kwargs()))
    tnet.load_state_dict(from_flax_variables(v), strict=True)
    tnet.train()
    with step_rng(torch.Generator().manual_seed(0)):
        out = tnet(*(torch.from_numpy(a) for a in (feat, feat_len, text,
                                                   text_len)))
    assert out["cross_att"].shape == (3, H, 7, out["ctc_logits"].shape[1])
    loss, tm = arasr_loss(out, torch.from_numpy(text),
                          torch.from_numpy(text_len), tnet.cfg)
    assert sorted(tm) == sorted(jm) and {"ilm_loss", "att_guid_loss"} <= set(
        tm)
    for k in jm:
        close(tm[k], jm[k], what=k)
    loss.backward()
    _grads_close(jg, {n: p.grad for n, p in tnet.named_parameters()}, "asr")
    assert tnet.decoder.training and tnet.dec_emb.training


def test_asr_config_accepts_the_reference_recipes_options():
    """The causal conformer, ILM and guidance build without raising; the
    conformer's FFNs raise on 'moe', as the reference's do."""
    ARASRNet(ARASRConfig(**_asr_kwargs()))
    with pytest.raises(NotImplementedError):
        ConformerEncoder(**dict(_enc_kwargs(), fdfwd_type="moe",
                                fdfwd_args=dict(num_experts=2)))
