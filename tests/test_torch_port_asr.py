"""The PyTorch port's ASR serving path against the JAX package, on the CPU.

A tiny conformer ARASRNet's variable shapes come from ``jax.eval_shape``
of its JAX init; seeded numpy values fill them and are bridged into the
port's ARASRNet;
both decode the same numpy waveforms (the port with ``device="cpu"``,
i.e. the kernels' plain versions).

Tolerances: encoder output 1e-4 relative to max|x|; decoder logits 1e-4
per step; beam search hypotheses token-equal and scores within 1e-4.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.models.ar_asr import ARASRConfig as JConfig
from speechain_tpu.models.ar_asr import ARASRNet as JNet
from speechain_tpu.ops.feat_norm import FeatNormConfig as JFN
from speechain_tpu.ops.frontend import FrontendConfig as JFE
from speechain_tpu_torch.models.ar_asr import ARASRConfig, ARASRNet
from speechain_tpu_torch.ops.feat_norm import FeatNormConfig
from speechain_tpu_torch.ops.frontend import FrontendConfig
from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               to_flax_variables)

V, D, L = 23, 32, 9600


def _cfg_kwargs():
    return dict(
        vocab_size=V,
        enc_prenet=dict(conv_dims=[8, 8], conv_kernel=3, conv_stride=2,
                        conv_batchnorm=True, conv_activation="LeakyReLU",
                        lnr_dims=D),
        encoder_type="conformer",
        encoder=dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
                     fdfwd_activation="GELU", depthwise_kernel_size=7),
        dec_emb=dict(embedding_dim=D),
        decoder=dict(d_model=D, num_heads=4, num_layers=2, fdfwd_dim=64,
                     fdfwd_activation="GELU"),
        ctc_weight=0.3)


def _random_tree(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", getattr(path[-1], "name", "")))
        shape = x.shape
        if x.dtype == bool:
            return np.ones(shape, bool)
        if name in ("var", "std", "aver_std"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("kernel", "embedding"):
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else 1
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "batch":
            v = np.ones(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(frontend=JFE(n_mels=16, preemphasis=0.97),
                   feat_norm=JFN(feat_dim=16), **_cfg_kwargs())
    jnet = JNet(cfg=jcfg)
    B = 2
    shapes = jax.eval_shape(
        jnet.init, {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, L, 1)),
        jnp.full((B,), L, jnp.int32), jnp.ones((B, 5), jnp.int32),
        jnp.full((B,), 5, jnp.int32))
    variables = _random_tree(shapes, seed=11)
    # make <eos> likely, so beams finish early and the finished pool and
    # the eos filter take part in the search
    variables["params"]["postnet"]["linear"]["bias"][V - 1] += 4.0
    tcfg = ARASRConfig(frontend=FrontendConfig(n_mels=16, preemphasis=0.97),
                       feat_norm=FeatNormConfig(feat_dim=16),
                       **_cfg_kwargs())
    tnet = ARASRNet(tcfg)
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    return jnet, variables, tnet.eval()


def _waves(int16=False, seed=12):
    rng = np.random.default_rng(seed)
    wave = (0.1 * rng.standard_normal((2, L, 1))).astype(np.float32)
    if int16:
        wave = np.round(wave * 32768).astype(np.int16)
    wave_len = np.array([L, L - 2345], np.int32)
    return wave, wave_len


def _jax_encode(jnet):
    """The JAX encoder, jitted: one compile is faster than op-by-op."""
    return jax.jit(lambda v, w, n: jnet.apply(v, w, n,
                                              method=jnet.encode)[:3])


def test_weight_bridge_round_trip(models):
    jnet, variables, tnet = models
    back = to_flax_variables(tnet.state_dict())
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        key = tuple(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)
        match = [v for k, v in got.items()
                 if tuple(str(getattr(p, "key", p)) for p in k) == key]
        assert len(match) == 1, key
        np.testing.assert_array_equal(match[0], np.asarray(leaf),
                                      err_msg=str(key))


@pytest.mark.parametrize("int16", [False, True])
def test_encode_matches_jax(models, int16):
    jnet, variables, tnet = models
    wave, wave_len = _waves(int16)
    jenc, jlen, jmask = _jax_encode(jnet)(variables, jnp.asarray(wave),
                                          jnp.asarray(wave_len))
    with torch.inference_mode():
        tenc, tlen, tmask = tnet.encode(torch.from_numpy(wave),
                                        torch.from_numpy(wave_len))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    err = np.abs(tenc.numpy() - np.asarray(jenc)).max()
    assert err <= 1e-4 * np.abs(np.asarray(jenc)).max(), err
    jctc = jnet.apply(variables, jenc, method=jnet.ctc_logits)
    with torch.inference_mode():
        tctc = tnet.ctc_logits(tenc)
    err = np.abs(tctc.numpy() - np.asarray(jctc)).max()
    assert err <= 1e-4 * np.abs(np.asarray(jctc)).max(), err


def test_decoder_logits_match_jax_per_step(models):
    jnet, variables, tnet = models
    wave, wave_len = _waves()
    J = jnp.asarray
    jenc, _, jmask = _jax_encode(jnet)(variables, J(wave), J(wave_len))
    cap = 6
    tokens = np.array([[V - 1], [V - 1]], np.int32)
    _, primed = jax.jit(lambda v, tok, enc, m: jnet.apply(
        v, tok, enc, m, prime=True, cache_capacity=cap,
        method=jnet.decode_step, mutable=["cache"]))(
        variables, J(tokens), jenc, jmask)
    jcache = primed["cache"]
    jstep = jax.jit(lambda v, c, tok, enc, m: jnet.apply(
        {**v, "cache": c}, tok, enc, m, method=jnet.decode_step,
        mutable=["cache"]))
    with torch.inference_mode():
        tenc, _, tmask = tnet.encode(torch.from_numpy(wave),
                                     torch.from_numpy(wave_len))
        tcache = tnet.prime(tenc, cap)
        for step in range(cap - 1):
            jlog, upd = jstep(variables, jcache, J(tokens), jenc, jmask)
            jcache = upd["cache"]
            tlog = tnet.decode_step(torch.from_numpy(tokens).long(), tcache,
                                    tmask)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=1e-4, rtol=0,
                                       err_msg=f"step {step}")
            tokens = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]


@pytest.mark.parametrize("eos_filtering,eos_threshold", [
    (False, 1.5),           # beams end at <eos> (length 4 here)
    (True, 1.5),            # the filter passes those <eos>
    (True, -1e9)])          # the filter rejects every <eos>: full length
def test_beam_search_matches_jax(models, eos_filtering, eos_threshold):
    """The whole slice: make_asr_decoder in JAX against the port on the
    CPU; hypotheses token-equal, scores within 1e-4."""
    from speechain_tpu.infer.asr import make_asr_decoder as jmake
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    jnet, variables, tnet = models
    wave, wave_len = _waves(seed=13)
    kw = dict(beam_size=4, eos_filtering=eos_filtering,
              eos_threshold=eos_threshold, max_len=8, sent_per_beam=2)
    jout = jmake(jnet, **kw)(variables, jnp.asarray(wave),
                             jnp.asarray(wave_len))
    tout = make_asr_decoder(tnet, device="cpu", **kw)(
        torch.from_numpy(wave), torch.from_numpy(wave_len))
    np.testing.assert_array_equal(tout["hypo_text"].numpy(),
                                  np.asarray(jout["hypo_text"]))
    np.testing.assert_array_equal(tout["hypo_text_len"].numpy(),
                                  np.asarray(jout["hypo_text_len"]))
    np.testing.assert_allclose(tout["hypo_text_confid"].numpy(),
                               np.asarray(jout["hypo_text_confid"]),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tout["nbest_text"].numpy(),
                                  np.asarray(jout["nbest_text"]))
    np.testing.assert_allclose(tout["nbest_confid"].numpy(),
                               np.asarray(jout["nbest_confid"]), atol=1e-4,
                               rtol=0)
    assert int(tout["hypo_text_len"][0]) == (7 if eos_threshold < 0 else 4)
    np.testing.assert_allclose(tout["feat_token_len_ratio"].numpy(),
                               np.asarray(jout["feat_token_len_ratio"]),
                               rtol=1e-6)


def test_random_state_dict_is_seeded_and_complete(models):
    from speechain_tpu_torch.utils.weights import random_state_dict
    tnet = models[2]
    a, b = random_state_dict(tnet, 3), random_state_dict(tnet, 3)
    assert a.keys() == tnet.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["postnet.linear.weight"],
                           random_state_dict(tnet, 4)["postnet.linear.weight"])


def test_lm_weight_without_lm_net_is_attention_only(models):
    """lm_weight > 0 with no lm_net is ignored, as in the JAX package: the
    search equals the attention-only one."""
    from speechain_tpu_torch.infer.asr import asr_beam_search
    _, _, tnet = models
    wave, wave_len = _waves()
    args = (tnet, torch.from_numpy(wave), torch.from_numpy(wave_len))
    kw = dict(beam_size=4, max_len=10)
    plain = asr_beam_search(*args, **kw)
    ignored = asr_beam_search(*args, lm_weight=0.5, lm_window_size=3, **kw)
    for key in ("hypo_text", "hypo_text_len", "hypo_text_confid"):
        assert torch.equal(ignored[key], plain[key]), key


def test_entry_point_needs_a_card_unless_cpu_is_asked(models):
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    from speechain_tpu_torch.utils.device import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_asr_decoder(models[2])


def test_port_imports_no_jax():
    """Importing the whole port pulls in no jax and no speechain_tpu
    module."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import speechain_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith(('jax.', 'jaxlib', 'flax'))"
        " or k == 'speechain_tpu' or k.startswith('speechain_tpu.'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
