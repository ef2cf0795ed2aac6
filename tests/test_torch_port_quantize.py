"""``speechain_tpu_torch/infer/quantize.py`` (``infer_cfg: weight_quant:
int8``) against ``speechain_tpu/infer/quantize.py``, on the CPU.

- the int8 values and the scales bit-equal to ``quantize_variables`` on
  the same weights through the bridge (``utils/weights.py``) for a small
  conformer ASR net, an LM and a Transformer-TTS net: the same leaves
  chosen, each kernel scaled per out channel and each token embedding
  table per row;
- ``dequantize_state_dict`` the identity on a float state, and within
  half a step of the float weights on a quantized one;
- ``quantized_bytes`` equal to JAX's;
- ``serve_quantized``: a beam-search decode of a tiny transformer ASR on
  int8 weights token-equal to JAX's ``make_asr_decoder`` on the quantized
  variables (float32, 1e-4 on the confidences), the float weights back in
  the network after each call; Transformer-TTS frames on int8 weights
  against JAX's ``tts_auto_regression`` on ``dequantize_variables(q)``
  (``tests/test_torch_port_tts_runner.py``, through the runner).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.infer.asr import make_asr_decoder as jmake_asr_decoder
from speechain_tpu.infer.quantize import (MARKER, quantize_variables,
                                          quantized_bytes as jbytes)
from speechain_tpu.builders import build_model as jbuild_model
from speechain_tpu_torch.builders import build_model
from speechain_tpu_torch.infer import quantize as Q
from speechain_tpu_torch.utils.weights import (_param_to_torch,
                                               random_state_dict,
                                               to_flax_variables)
from tests.test_torch_port_runner import INIT_MODELS

MIN = 1900          # from the conformer's depthwise kernel (1,984 elements) up


def _lm_model():
    return dict(model_type="lm.LM", module_conf=dict(
        emb=dict(conf=dict(embedding_dim=64)),
        encoder=dict(conf=dict(d_model=64, num_heads=2, num_layers=1,
                               fdfwd_dim=128))))


MODELS = {"conformer_asr": INIT_MODELS["conformer_asr"],
          "lm": _lm_model(),
          "transformer_tts": INIT_MODELS["transformer_tts"]}


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and MARKER not in v:
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _state(model, seed=0):
    """A seeded state of the model block's port net without its
    positional tables (no flax variable holds them), and its parameter
    names."""
    net, _, _ = build_model(model, 100)
    sd = {k: v for k, v in random_state_dict(net, seed).items()
          if not k.endswith(".table")}
    return sd, {n for n, _ in net.named_parameters()}


@pytest.mark.parametrize("case", list(MODELS))
def test_int8_values_and_scales_equal_jax(case):
    sd, params = _state(MODELS[case])
    variables = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(sd))
    # eager, as the JAX runner calls it (under jit XLA may fold the
    # division by 127 into a product, which rounds otherwise)
    jq = quantize_variables(variables, min_elems=MIN)
    tq = Q.quantize_state_dict(sd, MIN, params=params)
    got = {k for k, v in tq.items() if isinstance(v, Q.Int8Weight)}
    want, tables = set(), 0
    for path, node in _flax_leaves(jq["params"]):
        if not (isinstance(node, dict) and MARKER in node):
            continue
        name, q8 = _param_to_torch(path, np.asarray(node[MARKER]))
        want.add(name)
        w = tq[name]
        assert w.q8.dtype == torch.int8 and w.dtype == torch.float32
        np.testing.assert_array_equal(w.q8.numpy(), q8, err_msg=name)
        np.testing.assert_array_equal(
            w.scale.numpy().reshape(-1),
            np.asarray(node["scale"]).reshape(-1), err_msg=name)
        if path[-1] == "embedding":           # one scale a row
            assert w.scale.shape == (w.q8.shape[0], 1), name
            tables += 1
        else:                                 # one an out channel
            assert w.scale.shape[0] == w.q8.shape[0], name
            assert w.scale.numel() == w.q8.shape[0], name
    assert got == want and len(got) >= 4
    assert tables == 1                     # the token table
    # buffers and small leaves stay float and untouched
    for k, v in tq.items():
        if k not in got:
            assert v is sd[k], k
    now, deq = Q.quantized_bytes(tq)
    assert (now, deq) == jbytes(jq)
    assert now < deq


def test_dequantize_is_the_identity_on_a_float_state_and_half_a_step():
    sd, params = _state(MODELS["transformer_tts"])
    assert all(a is b for a, b in zip(Q.dequantize_state_dict(sd).values(),
                                      sd.values()))
    tq = Q.quantize_state_dict(sd, MIN, params=params)
    back = Q.dequantize_state_dict(tq)
    assert back.keys() == sd.keys()
    for k, v in tq.items():
        if isinstance(v, Q.Int8Weight):
            err = (back[k] - sd[k]).abs()
            assert bool((err <= v.scale / 2 + 1e-7).all()), k
            assert back[k].dtype == sd[k].dtype
        else:
            assert torch.equal(back[k], sd[k])


def test_quantized_asr_decode_equals_jax():
    """beam 3 over a tiny transformer ARASRNet on int8 weights: the port
    (``serve_quantized`` over ``make_asr_decoder``) against JAX's
    ``make_asr_decoder`` on ``quantize_variables``."""
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    model = dict(
        model_type="ar_asr.ARASR", model_conf=dict(customize_conf=dict()),
        module_conf=dict(
            frontend=dict(conf=dict(sr=8000, n_mels=16, fmax=4000)),
            normalize=True,
            enc_prenet=dict(conf=dict(conv_dims=[8, 8], lnr_dims=64)),
            encoder=dict(conf=dict(d_model=64, num_heads=2, num_layers=1,
                                   fdfwd_dim=128)),
            dec_emb=dict(conf=dict(embedding_dim=64)),
            decoder=dict(conf=dict(d_model=64, num_heads=2, num_layers=1,
                                   fdfwd_dim=128))))
    V = 40
    net, _, _ = build_model(model, V)
    sd = random_state_dict(net, 3)
    net.load_state_dict(sd, strict=True)
    flat = {k: v for k, v in sd.items() if not k.endswith(".table")}
    variables = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(flat))
    jnet, _, _ = jbuild_model(model, V)
    rng = np.random.default_rng(0)
    wave = (0.3 * rng.standard_normal((2, 4000, 1))).astype(np.float32)
    wave_len = np.array([4000, 3100], np.int32)
    jout = jmake_asr_decoder(jnet, beam_size=3)(
        quantize_variables(variables, min_elems=MIN), jnp.asarray(wave),
        jnp.asarray(wave_len))
    float_weights = {k: v.clone() for k, v in net.state_dict().items()}
    qweights = Q.quantize_net(net, MIN)
    assert len(qweights) >= 6
    decode = Q.serve_quantized(net, qweights, make_asr_decoder(
        net, device="cpu", beam_size=3))
    out = decode(torch.from_numpy(wave), torch.from_numpy(wave_len))
    np.testing.assert_array_equal(out["hypo_text_len"].numpy(),
                                  np.asarray(jout["hypo_text_len"]))
    for i in range(2):
        n = int(out["hypo_text_len"][i])
        np.testing.assert_array_equal(out["hypo_text"][i][:n].numpy(),
                                      np.asarray(jout["hypo_text"][i][:n]))
    np.testing.assert_allclose(out["hypo_text_confid"].numpy(),
                               np.asarray(jout["hypo_text_confid"]),
                               rtol=1e-4, atol=1e-4)
    # the float weights are back after the call
    for k, v in net.state_dict().items():
        assert torch.equal(v, float_weights[k]), k
    # and the int8 decode is not the float one's scores
    fout = make_asr_decoder(net, device="cpu", beam_size=3)(
        torch.from_numpy(wave), torch.from_numpy(wave_len))
    assert not torch.equal(fout["hypo_text_confid"],
                           out["hypo_text_confid"])
