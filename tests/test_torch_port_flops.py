"""``speechain_tpu_torch/utils/flops.py`` is a copy of
``speechain_tpu/utils/flops.py``: every counter equal to the JAX
package's at the recipes' widths."""

import inspect

import pytest

from speechain_tpu.utils import flops as jflops
from speechain_tpu_torch.utils import flops as tflops

CASES = {
    "linear": (3184, 256, 1024),
    "mhsa": (199, 199, 256),
    "ffn": (3184, 256, 1024),
    "conformer_layer": (199, 256, 1024, 31),
    "conformer_encoder": (199, 12, 256, 1024, 31),
    "transformer_encoder": (199, 12, 512, 2048),
    "transformer_decoder": (1, 31, 199, 6, 512, 2048),
    "conv2d_subsample_prenet": (801, 80, (256, 256)),
    "ref_beam_search_decoder_flops": (30, 199, 16, 6, 256, 1024, 1000),
    "cached_beam_search_decoder_flops": (30, 199, 16, 6, 256, 1024, 1000),
    "fastspeech2_fwd_flops": (100, 640, 384, 1536, 4, 4, 80),
    "hifigan_fwd_flops": (640,),
}


def test_every_counter_is_covered():
    names = {n for n, f in inspect.getmembers(tflops, inspect.isfunction)
             if f.__module__ == tflops.__name__}
    assert names == set(CASES) == {
        n for n, f in inspect.getmembers(jflops, inspect.isfunction)
        if f.__module__ == jflops.__name__}


@pytest.mark.parametrize("name", sorted(CASES))
def test_counter_equals_jax(name):
    args = CASES[name]
    got, want = getattr(tflops, name)(*args), getattr(jflops, name)(*args)
    assert got == want and got > 0
