"""The port's Switch-MoE FFN and the MoE language model against the JAX
package, on the CPU.

``SwitchFFN`` alone (B 4, T 16, D 16, F 32, 4 experts) at the recipe's
capacity factor 1.25 with GELU (the tanh form flax resolves) and at 0.25
with ReLU, where every expert overflows its 8 slots and tokens drop.
Then a tiny LM of the 960-bpe5k MoE recipe's structure (2 layers, d 32,
4 heads, F 64 GELU, 4 experts, capacity 1.25, the embedding unscaled,
V 23): forward, KV-cached ``decode_step`` (capacity of that call's rows)
and one ``make_lm_step`` with the recipe's optimizer. Seeded numpy values
fill the JAX variables, bridged with ``from_flax_variables`` (strictly).
float32, dropout 0.

The route is a discrete choice. Where a token's top two router
probabilities in JAX's pass lie within ``MARGIN`` = 1e-6, float32 sums in
another order may pick the other expert: such tokens are reported and
the port follows JAX's route for them (``follow_routes``); with these
seeds none occurs, and the cases are not re-seeded to avoid one.

Tolerances: outputs and gradients 1e-5 of max(1, the array's largest
magnitude); the auxiliary loss 1e-5 relative; routes and dropped tokens
equal; bf16 outputs within 2^-6 of max(1, max|ref|) and, with the experts
reduced to their output bias, bit-equal (the gate rounded to bf16 before
its product, ``combine.astype(self.dtype)``); after one LM step the loss
and ``moe_aux`` 1e-5 relative, parameters within 1e-5 of each array's
largest magnitude and Adam's first moments (the gradients) within 1e-4 of
each's largest (or 1e-6 of the largest of all).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu.nn.lm import LanguageModelNet as JLM
from speechain_tpu.nn.lm import LMConfig as JLMConfig
from speechain_tpu.nn.moe import SwitchFFN as JSwitch
from speechain_tpu_torch.nn import moe
from speechain_tpu_torch.nn.lm import LanguageModelNet, LMConfig
from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               to_flax_variables)
from tests.test_torch_port_asr import _random_tree
from tests.test_torch_port_tts_train import first_moments, quick_jit

MARGIN = 1e-6
B, T, D, F, E = 4, 16, 16, 32, 4
V, LM_D = 23, 32


def close(got, want, tol=1e-5, what=""):
    want = np.asarray(want)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


def randomize(variables, seed):
    """_random_tree's values, the experts' weights ~ N(0, 1 / fan_in)."""
    tree = _random_tree({k: v for k, v in variables.items()
                         if k != "losses"}, seed)
    rng = np.random.default_rng(seed + 1)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", ""))
        if name in ("expert_wi", "expert_wo"):
            return (rng.standard_normal(x.shape)
                    / np.sqrt(x.shape[1])).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_routes(logits):
    """JAX's routes from router logits (S, E): expert, and the tokens
    whose top-2 probabilities lie within MARGIN."""
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    top2 = np.sort(p, -1)[:, -2:]
    return p.argmax(-1), np.nonzero(top2[:, 1] - top2[:, 0] < MARGIN)[0]


@contextlib.contextmanager
def follow_routes(routes):
    """The port's route takes JAX's expert for the near-tie tokens of
    each call, in call order: ``routes`` a list of (expert, near)."""
    calls = iter(routes)
    plain = moe.route

    def route(probs, cap):
        expert, near = next(calls)
        pick = probs.argmax(-1)
        if len(near):
            print(f"router near-ties {near.tolist()}: following JAX")
            pick[torch.as_tensor(near)] = torch.as_tensor(expert[near])
        gate = probs.gather(1, pick[:, None])[:, 0]
        pos = moe.queue_positions(pick, probs.shape[-1])
        return pick, gate, pos, pos <= cap

    moe.route = route
    try:
        yield
    finally:
        moe.route = plain


# ---- SwitchFFN ------------------------------------------------------------

CASES = [(1.25, "GELU"), (0.25, "ReLU")]


@pytest.mark.parametrize("cf,act", CASES)
def test_switch_ffn_matches_jax(cf, act):
    """Outputs, routes, dropped tokens, the auxiliary loss and the
    gradients of sum(out * g) + aux in x and every parameter."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    jm = JSwitch(d_model=D, fdfwd_dim=F, num_experts=E, capacity_factor=cf,
                 fdfwd_activation=act, dropout=0.0)
    v = randomize(jm.init({"params": jax.random.PRNGKey(0)},
                          jnp.asarray(x)), seed=8)

    def jloss(params, xj):
        out, sown = jm.apply({"params": params}, xj, mutable=["losses"])
        aux = sown["losses"]["moe_aux"]
        return jnp.sum(out * g) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = quick_jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    W, b = v["params"]["router"]["kernel"], v["params"]["router"]["bias"]
    expert, near = jax_routes(x.reshape(-1, D) @ W + b)

    tm = moe.SwitchFFN(D, F, E, cf, act, dropout=0.0)
    tm.load_state_dict(from_flax_variables(v), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with moe.collect_losses() as aux, follow_routes([(expert, near)]):
        out = tm(xt)
    cap = moe.capacity(B * T, E, cf)
    _, _, _, keep = moe.route(torch.softmax(
        tm.router(xt.detach()), -1).reshape(-1, E), cap)
    dropped = ~keep.numpy()
    assert np.array_equal(dropped, np.abs(np.asarray(jout)).reshape(
        -1, D).max(-1) == 0)
    assert dropped.any() == (cf < 1.0)
    assert len(aux) == 1
    np.testing.assert_allclose(float(aux[0].detach()), float(jaux),
                               rtol=1e-5)
    close(out, jout, what="out")
    ((out * torch.from_numpy(g)).sum() + aux[0]).backward()
    close(xt.grad, jgx, what="dx")
    want = from_flax_variables({"params": jgp})
    for name, p in tm.named_parameters():
        close(p.grad, want[name].numpy(), what=name)


def test_switch_ffn_bf16_rounds_the_gate_as_jax():
    """bf16 compute: outputs within 2^-6 of JAX's; with the experts'
    inner weights and biases zeroed every kept token's output is
    round(round(gate) * bo), bit-equal to JAX's, which a product with
    the float32 gate would not be."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jm = JSwitch(d_model=D, fdfwd_dim=F, num_experts=E, dropout=0.0,
                 dtype=jnp.bfloat16)
    v = randomize(jm.init({"params": jax.random.PRNGKey(0)},
                          jnp.asarray(x)), seed=10)
    tm = moe.SwitchFFN(D, F, E, dropout=0.0, dtype=torch.bfloat16)
    tm.load_state_dict(from_flax_variables(v), strict=True)
    xb = jnp.asarray(x, jnp.bfloat16)
    jout = np.asarray(jm.apply(v, xb).astype(jnp.float32))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(torch.bfloat16)).float()
    close(out, jout, tol=2.0 ** -6, what="bf16 out")

    p = dict(v["params"])
    p["expert_wi"] = np.zeros_like(p["expert_wi"])
    p["expert_bi"] = np.zeros_like(p["expert_bi"])
    p["expert_bo"] = np.asarray(jnp.asarray(p["expert_bo"], jnp.bfloat16)
                                .astype(jnp.float32))
    jout = np.asarray(jm.apply({"params": p}, xb).astype(jnp.float32))
    tm.load_state_dict(from_flax_variables({"params": p}), strict=True)
    with torch.no_grad():
        xt = torch.from_numpy(x).to(torch.bfloat16)
        out = tm(xt).float().numpy()
        probs = torch.softmax(tm.router(xt.float()), -1).reshape(-1, E)
        gate, expert = probs.max(-1)
    np.testing.assert_array_equal(out, jout)
    bo = torch.tensor(p["expert_bo"])[expert, 0]
    unrounded = (gate[:, None] * bo).to(torch.bfloat16).float().numpy()
    assert (unrounded != out.reshape(-1, D)).any()


def test_capacity_and_activation_follow_the_reference():
    """cap = min(max(8, ceil8(ceil(S cf / E))), S), padding counted; the
    MoE's GELU is the tanh form, ReLU / SiLU / Swish as flax's."""
    assert moe.capacity(32 * 140, 8, 1.25) == 704
    assert moe.capacity(16 * 16, 8, 1.25) == 40
    assert moe.capacity(10, 4, 1.25) == 8 and moe.capacity(5, 4, 1.25) == 5
    assert moe.capacity(100, 4, 0.5) == 16 and moe.capacity(27, 4, 1.25) == 16
    z = np.linspace(-4, 4, 41).astype(np.float32)
    for name, jf in (("GELU", jax.nn.gelu), ("ReLU", jax.nn.relu),
                     ("SiLU", jax.nn.silu), ("Swish", jax.nn.swish)):
        got = moe.ACTIVATIONS[name.lower()](torch.from_numpy(z))
        close(got, jf(jnp.asarray(z)), tol=1e-6, what=name)
    with pytest.raises(KeyError):
        moe.SwitchFFN(D, F, E, fdfwd_activation="LeakyReLU")


# ---- the MoE language model -----------------------------------------------

OPT = dict(optim_conf=dict(betas=(0.9, 0.98), eps=1e-9), d_model=LM_D,
           warmup_steps=50000)


def _lm_kwargs():
    drop = dict(posenc_dropout=0.0, fdfwd_dropout=0.0, att_dropout=0.0,
                res_dropout=0.0)
    return dict(vocab_size=V, emb=dict(embedding_dim=LM_D, emb_scale=False),
                encoder=dict(d_model=LM_D, num_heads=4, num_layers=2,
                             fdfwd_dim=64, fdfwd_activation="GELU",
                             fdfwd_type="moe",
                             fdfwd_args=dict(num_experts=4,
                                             capacity_factor=1.25),
                             **drop))


def _text(seed, lens=(9, 5, 9)):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, V - 1, (len(lens), max(lens))).astype(np.int32)
    text[:, 0] = V - 1
    for i, n in enumerate(lens):
        text[i, n - 1] = V - 1
        text[i, n:] = 0
    return text, np.array(lens, np.int32)


def with_router_logits(jnet, **kw):
    """``(variables, *args) -> (output, the updated collections, each
    layer's router logits (S, E) in layer order)`` of a JAX pass,
    compiled once."""
    def run(variables, *args):
        out, inter = jnet.apply(
            variables, *args, capture_intermediates=lambda m, _:
            m.name == "router", mutable=["intermediates", "losses", "cache"],
            **kw)
        enc = inter.pop("intermediates")["encoder"]
        return out, inter, [enc[f"layer_{i}"]["feed_forward"]["router"]
                     ["__call__"][0].reshape(-1, 4) for i in range(len(enc))]
    return quick_jit(run)


@pytest.fixture(scope="module")
def lms():
    jnet = JLM(cfg=JLMConfig(**_lm_kwargs()))
    text, text_len = _text(30)
    shapes = jax.eval_shape(jnet.init, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(text), jnp.asarray(text_len))
    variables = randomize(shapes, seed=31)
    tnet = LanguageModelNet(LMConfig(**_lm_kwargs()))
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    return jnet, variables, tnet.eval()


def test_moe_lm_forward_and_bridge_match_jax(lms):
    jnet, variables, tnet = lms
    text, text_len = _text(32)
    (jlogits, _, _), _, lgs = with_router_logits(jnet)(
        variables, jnp.asarray(text), jnp.asarray(text_len))
    routes = [jax_routes(lg) for lg in lgs]
    with torch.no_grad(), follow_routes(routes):
        logits, _ = tnet(torch.from_numpy(text), torch.from_numpy(text_len))
    close(logits, jlogits, what="logits")
    back = to_flax_variables(tnet.state_dict())["params"]
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_moe_lm_decode_step_matches_jax(lms):
    """Four cached steps of 3 rows: each call routes its 3 tokens at the
    capacity of 3 rows (min(8, S) = 3)."""
    jnet, variables, tnet = lms
    text, _ = _text(33, lens=(4, 4, 4))
    _, primed = quick_jit(lambda v, tok: jnet.apply(
        v, tok, prime=True, cache_capacity=6, method=jnet.decode_step,
        mutable=["cache", "losses"]))(variables, jnp.asarray(text[:, :1]))
    jstep = with_router_logits(jnet, method=jnet.decode_step)
    jcache = primed["cache"]
    cache = tnet.prime(3, 6)
    with torch.no_grad():
        for i in range(4):
            jlogits, upd, lgs = jstep({**variables, "cache": jcache},
                                        jnp.asarray(text[:, i:i + 1]))
            jcache = upd["cache"]
            with follow_routes([jax_routes(lg) for lg in lgs]):
                logits = tnet.decode_step(torch.from_numpy(text[:, i:i + 1]),
                                          cache)
            close(logits, jlogits, what=f"step {i}")


def test_moe_lm_step_matches_jax(lms):
    """One make_lm_step (label smoothing 0.1): loss, ``moe_aux`` (the two
    layers' summed), every parameter and Adam's first moments."""
    from speechain_tpu.train.optim import build_optimizer as jbuild
    from speechain_tpu.train.state import init_train_state as jinit
    from speechain_tpu.train.state import make_lm_step as jmake
    from speechain_tpu_torch.train.optim import build_optimizer
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_lm_step)
    jnet, variables, _ = lms
    text, text_len = _text(36)
    jtx = jbuild(**OPT)
    jstate = jinit(jax.tree_util.tree_map(jnp.asarray, variables), jtx)
    jstep = quick_jit(jmake(jnet, jtx, label_smoothing=0.1, axis_name=None))
    jstate, jm = jstep(jstate, dict(text=jnp.asarray(text),
                                    text_len=jnp.asarray(text_len)),
                       jax.random.PRNGKey(0))
    _, _, lgs = with_router_logits(jnet)(variables, jnp.asarray(text),
                                         jnp.asarray(text_len))
    routes = [jax_routes(lg) for lg in lgs]

    tnet = LanguageModelNet(LMConfig(**_lm_kwargs()))
    tnet.load_state_dict(from_flax_variables(variables), strict=True)
    tx = build_optimizer(**OPT)
    state = init_train_state(tnet, tx, device="cpu")
    step = make_lm_step(tnet, tx, label_smoothing=0.1, device="cpu")
    batch = dict(text=torch.from_numpy(text).long(),
                 text_len=torch.from_numpy(text_len).long())
    with follow_routes(routes):
        state, tm = step(state, batch, torch.Generator().manual_seed(0))
    assert sorted(tm) == sorted(jm) and "moe_aux" in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jstate.params)})
    for name, p in tnet.named_parameters():
        close(p, want[name].numpy(), what=name)
    leaves, tree = jax.tree_util.tree_flatten(jstate.params)
    mu = np.asarray(jstate.opt_state["inner"][0].mu)
    ends = np.cumsum([x.size for x in leaves])
    want = from_flax_variables({"params": jax.tree_util.tree_unflatten(
        tree, [m.reshape(x.shape) for m, x in zip(np.split(mu, ends[:-1]),
                                                  leaves)])})
    got = first_moments(tnet, state.opt_state["mu"])
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= max(1e-4 * float(w.abs().max()), 1e-6 * scale), (
            name, err)


def test_moe_builds_only_in_the_encoder_layer():
    """fdfwd_type 'moe' raises in the position-wise FFN (the decoder and
    conformer layers), as the reference's does."""
    from speechain_tpu_torch.nn.feed_forward import PositionwiseFeedForward
    from speechain_tpu_torch.nn.transformer import (TransformerDecoderLayer,
                                                    TransformerEncoderLayer)
    layer = TransformerEncoderLayer(16, 2, fdfwd_dim=32, fdfwd_type="moe",
                                    fdfwd_args=dict(num_experts=2))
    assert isinstance(layer.feed_forward, moe.SwitchFFN)
    with pytest.raises(NotImplementedError):
        PositionwiseFeedForward(16, 32, "moe")
    with pytest.raises(NotImplementedError):
        TransformerDecoderLayer(16, 2, fdfwd_dim=32, fdfwd_type="moe")
