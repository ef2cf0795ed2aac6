"""The port's Transformer-TTS synthesis against the JAX package's, on the
CPU.

``tts_auto_regression`` (the port's host loop over KV-cached decoder
steps) against the JAX package's ``lax.while_loop``, with the same seeded
weights (the port's ``random_state_dict``, bridged to flax by
``to_flax_variables``) and texts, float32, the decoder prenet's dropout
at 0 (the two packages draw dropout masks from different generators),
r = 2, ``maxlen_ratio`` 2 (caps of 9 and 6 steps for 9 and 6 tokens)
and ``max_frames`` 12. The stop head's bias is -1.4, so that both rows
fire before their caps (at steps 6 and 3, margins above 0.07 of the
logit); the cases cover that, ``continual_steps`` 1 and the pre-postnet
feedback (``use_before``). Tolerances: lengths exactly, the features
1e-5 of max(1, max|ref|) (float32 rounding through the fed-back frames).

The rest is the port alone: the dropout on at inference and drawn from
the caller's generator, outputs that do not depend on how often the loop
asks whether every row has stopped, the step count that the cap fixes,
and ``make_artts_synthesizer`` with Griffin-Lim and with HiFi-GAN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_artts import configs, text_batch
from tests.test_torch_port_tts_train import _t, quick_jit
from speechain_tpu_torch.utils.weights import (random_state_dict,
                                               to_flax_variables)

KEY = jax.random.PRNGKey(0)
STOP_BIAS = -1.4
DECODE = dict(maxlen_ratio=2.0, max_frames=12)
# (continual_steps, use_before) and the lengths (frames, r x steps) each
# case must give, checked against JAX too
SYNTH_CASES = {"stop": (0, False, [14, 8]), "continual": (1, False, [16, 10]),
               "use_before": (0, True, None)}


def artts(lnr_dropout=0.0, stop_bias=STOP_BIAS, seed=20):
    """The port's ARTTSNet (r = 2) with seeded random weights, in
    evaluation mode."""
    from speechain_tpu_torch.models.ar_tts import ARTTSNet
    net = ARTTSNet(configs(r=2, lnr_dropout=lnr_dropout)[1])
    sd = random_state_dict(net, seed)
    sd["stop_pred.bias"][:] = stop_bias
    net.load_state_dict(sd, strict=True)
    return net.eval()


@pytest.fixture(scope="module")
def jax_synth():
    """JAX's tts_auto_regression at every case, in one compiled
    function."""
    from speechain_tpu.infer.tts_decoding import tts_auto_regression
    from speechain_tpu.models.ar_tts import ARTTSNet as JNet
    jnet = JNet(cfg=configs(r=2)[0])
    v = jax.tree_util.tree_map(jnp.asarray,
                               to_flax_variables(artts().state_dict()))

    def run(v, text, text_len):
        return {name: tts_auto_regression(
            jnet, v, text, text_len, continual_steps=cont,
            use_before=before, rng=KEY, **DECODE)
            for name, (cont, before, _) in SYNTH_CASES.items()}

    text, text_len = text_batch()
    out = quick_jit(run)(v, jnp.asarray(text), jnp.asarray(text_len))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("case", list(SYNTH_CASES))
def test_tts_auto_regression_matches_jax(jax_synth, case):
    from speechain_tpu_torch.infer.tts_decoding import tts_auto_regression
    cont, before, lens = SYNTH_CASES[case]
    text, text_len = map(_t, text_batch())
    with torch.no_grad():
        got = tts_auto_regression(artts(), text, text_len,
                                  continual_steps=cont, use_before=before,
                                  **DECODE)
    want = jax_synth[case]
    assert got["hypo_feat"].shape == (2, 24, 80)
    np.testing.assert_array_equal(got["hypo_feat_len"].numpy(),
                                  want["hypo_feat_len"])
    if lens is not None:
        assert got["hypo_feat_len"].tolist() == lens      # before the caps
    ref = want["hypo_feat"]
    err = float(np.abs(got["hypo_feat"].numpy() - ref).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), err
    np.testing.assert_allclose(got["feat_token_len_ratio"].numpy(),
                               want["feat_token_len_ratio"], rtol=1e-6)
    n = got["hypo_feat_len"]
    for i in range(2):                    # zeros past each length
        assert float(got["hypo_feat"][i, n[i]:].abs().max()) == 0.0
        assert float(got["hypo_feat"][i, :n[i]].abs().min()) > 0.0


def test_prenet_dropout_is_on_and_drawn_from_the_generator(monkeypatch):
    """With the recipe's prenet dropout 0.5 in evaluation mode, the same
    generator seed gives the same features, another seed others, and
    dropout 0 others again; the loop asks whether every row has stopped
    every ``CHECK_EVERY`` steps, which changes nothing in the outputs."""
    from speechain_tpu_torch.infer import tts_decoding
    text, text_len = map(_t, text_batch())

    def run(seed, rate=0.5):
        with torch.no_grad():
            return tts_decoding.tts_auto_regression(
                artts(lnr_dropout=rate), text, text_len,
                generator=torch.Generator().manual_seed(seed), **DECODE)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a["hypo_feat"], b["hypo_feat"])
    assert not torch.equal(a["hypo_feat"], c["hypo_feat"])
    assert not torch.equal(a["hypo_feat"], run(1, rate=0.0)["hypo_feat"])
    for every in (1, 3):
        monkeypatch.setattr(tts_decoding, "CHECK_EVERY", every)
        d = run(1)
        assert torch.equal(a["hypo_feat"], d["hypo_feat"])
        assert torch.equal(a["hypo_feat_len"], d["hypo_feat_len"])


def test_steps_stop_at_the_caps_without_a_stop(monkeypatch):
    """A stop head that never fires: every row runs to its cap
    (text_len x maxlen_ratio / r + 1, less one: 9 and 6 steps, 18 and 12
    frames) and the loop runs exactly the longest cap's steps whatever
    ``CHECK_EVERY``; ``max_frames`` below that cap ends it there."""
    from speechain_tpu_torch.infer import tts_decoding
    from speechain_tpu_torch.infer.tts_decoding import tts_auto_regression
    net = artts(stop_bias=-100.0)
    text, text_len = map(_t, text_batch())
    with torch.no_grad():
        for every in (1, 4, 16):
            monkeypatch.setattr(tts_decoding, "CHECK_EVERY", every)
            out = tts_auto_regression(net, text, text_len, **DECODE)
            assert out["steps"] == 9, (every, out["steps"])
            assert out["hypo_feat_len"].tolist() == [18, 12]
        short = tts_auto_regression(net, text, text_len, maxlen_ratio=2.0,
                                    max_frames=5)
    assert short["steps"] == 5 and short["hypo_feat_len"].tolist() == [10, 10]
    assert short["hypo_feat"].shape == (2, 10, 80)


def test_make_artts_synthesizer_vocodes_the_recovered_features():
    """make_artts_synthesizer(net, "gl") equals tts_auto_regression, the
    feature norm's recovery and logmel_to_wave on the same phases;
    with a HiFi-GAN, the wave is the vocoder's over the same features
    and wave_len the frames times its hop; the defaults are the recipe's
    infer_cfg (F = int(L x 10 / r) + 1)."""
    from speechain_tpu_torch.infer.tts import make_artts_synthesizer
    from speechain_tpu_torch.infer.tts_decoding import tts_auto_regression
    from speechain_tpu_torch.nn.vocoder_hifigan import HiFiGAN
    from speechain_tpu_torch.ops.griffin_lim import logmel_to_wave
    net = artts(stop_bias=0.5)
    text, text_len = map(_t, text_batch())
    cfg = net.cfg.frontend
    with torch.no_grad():
        ref = tts_auto_regression(net, text, text_len,
                                  generator=torch.Generator().manual_seed(3))
    assert ref["hypo_feat"].shape == (2, 2 * 46, 80)
    assert 0 < int(ref["hypo_feat_len"].max()) < 2 * 46
    phases = torch.rand((2, 92, cfg.n_freqs),
                        generator=torch.Generator().manual_seed(4))
    out = make_artts_synthesizer(net, "gl", device="cpu", gl_iters=4)(
        text, text_len, generator=torch.Generator().manual_seed(3),
        gl_phases=phases)
    assert torch.equal(out["hypo_feat"], ref["hypo_feat"])
    with torch.no_grad():
        wave, wave_len = logmel_to_wave(net.recover_feat(ref["hypo_feat"]),
                                        ref["hypo_feat_len"], cfg, n_iter=4,
                                        phases=phases)
    assert torch.equal(out["wave"], wave)
    assert torch.equal(out["wave_len"], wave_len)
    voc = HiFiGAN(in_channels=80, upsample_initial_channel=16)
    voc.load_state_dict(random_state_dict(voc, 5))
    out = make_artts_synthesizer(net, voc, device="cpu")(
        text, text_len, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = voc(net.recover_feat(ref["hypo_feat"]))
    assert torch.equal(out["wave"], want)
    assert torch.equal(out["wave_len"], ref["hypo_feat_len"] * voc.hop)
    with pytest.raises(ValueError, match="vocoder"):
        make_artts_synthesizer(net, "world", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_artts_synthesizer(net)
