"""The port's schedules, optimizers, gradient accumulation and partial
updates against the JAX package's ``train/optim.py`` (optax), on the CPU.

Each case starts both sides from the same float32 parameters and feeds
the same seeded gradients (scaled so that the global-norm clip engages
at some updates), the JAX side through ``optax.apply_updates``, the port
in place. ``updated_modules`` and the optimizer groups are held on the
parameters of a tiny LM (2 layers, d 32), whose flax paths the reference
labels and whose port names the weight bridge resolves to the same
paths. Tolerances: schedules 1e-6 relative; parameters after each update
within 1e-6 of max(1, the array's largest magnitude); counters equal;
parameters that a call must leave alone bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechain_tpu.nn.lm import LanguageModelNet as JLM
from speechain_tpu.nn.lm import LMConfig as JLMConfig
from speechain_tpu.train import optim as joptim
from speechain_tpu_torch.train import optim as toptim
from speechain_tpu_torch.utils.weights import (flax_param_path,
                                               from_flax_variables)

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}


def close(got, want, tol=1e-6, what=""):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("sche,kw", [
    ("noam", dict(warmup_steps=10, d_model=None)),
    ("noam", dict(warmup_steps=4000, d_model=256, ft_factor=0.5)),
    ("exp", dict(decay_factor=0.9, steps_per_epoch=3)),
    ("exp", dict(decay_factor=0.999, steps_per_epoch=1000, ft_factor=2.0)),
])
def test_schedules_match_jax(sche, kw):
    if sche == "noam":
        js = joptim.noam_schedule(2e-3, **kw)
        ts = toptim.noam_schedule(2e-3, **kw)
    else:
        js = joptim.exp_decay_schedule(1e-3, **kw)
        ts = toptim.exp_decay_schedule(1e-3, **kw)
    for c in (0, 1, 2, 3, 5, 9, 2999, 3000, 40000):
        np.testing.assert_allclose(
            float(ts(torch.tensor(c, dtype=torch.int32))),
            float(js(jnp.int32(c))), rtol=1e-6, err_msg=str(c))


def _run(kw, grads_seq):
    """Both sides over ``grads_seq`` (a list of dicts of numpy arrays);
    returns per call (JAX params, port params, port state, JAX state)."""
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    names = sorted(SHAPES)
    jtx = joptim.build_optimizer(**kw)
    ttx = toptim.build_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.tensor(params[k]) for k in names]
    jst, tst = jtx.init(jp), ttx.init(tp, names)
    jupdate = jax.jit(jtx.update)
    out = []
    for grads in grads_seq:
        upd, jst = jupdate({k: jnp.asarray(v) for k, v in grads.items()},
                           jst, jp)
        jp = optax.apply_updates(jp, upd)
        tst = ttx.update([torch.tensor(grads[k]) for k in names], tst, tp)
        out.append(({k: np.asarray(v) for k, v in jp.items()},
                    {k: p.clone() for k, p in zip(names, tp)}, tst, jst))
    return out


def _grads(n, seed=5, inf_at=()):
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(n):
        g = {k: (3 * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()}
        if i in inf_at:
            g["b"][2] = np.inf
        seq.append(g)
    return seq


@pytest.mark.parametrize("optim_type,conf", [
    ("Adam", dict(betas=(0.9, 0.98), eps=1e-9)),
    ("AdamW", dict(betas=(0.9, 0.98), eps=1e-9, weight_decay=0.05)),
    ("AdamW", dict()),
    ("SGD", dict(momentum=0.9)),
    ("SGD", dict()),
])
@pytest.mark.parametrize("sche", ["noam", "exp"])
def test_optimizers_match_optax(optim_type, conf, sche):
    """Five flat-path updates (clip 1.0, the third gradient nonfinite and
    skipped): parameters after each, the count and the skip count."""
    kw = dict(sche_type=sche, optim_type=optim_type,
              optim_conf=dict(conf, lr=1e-2), warmup_steps=3,
              decay_factor=0.8, steps_per_epoch=2, grad_clip=1.0)
    for i, (jp, tp, tst, _) in enumerate(_run(kw, _grads(5, inf_at=(2,)))):
        for k in SHAPES:
            close(tp[k], jp[k], what=f"update {i} {k}")
    assert int(tst["count"]) == 4 and int(tst["notfinite"]) == 1


@pytest.mark.parametrize("k", [2, 3])
def test_gradient_accumulation_matches_multisteps(k):
    """optax.MultiSteps at k: the running mean of k gradients, one inner
    update at each k-th call (parameters bit-equal across the others),
    a nonfinite gradient at an emitting call skipped, and optax's reset
    ``0 * acc`` keeping the NaN it leaves, so every later update skips
    as the reference's does."""
    kw = dict(optim_conf=dict(lr=1e-2, betas=(0.9, 0.98), eps=1e-9),
              warmup_steps=3, grad_clip=5.0, accum_grad=k)
    bad = 2 * k - 1                     # the second emitting call
    runs = _run(kw, _grads(4 * k, inf_at=(bad,)))
    before = None
    for i, (jp, tp, tst, jst) in enumerate(runs):
        for name in SHAPES:
            close(tp[name], jp[name], what=f"call {i} {name}")
        if before is not None and (i % k != k - 1 or i >= bad):
            assert all(torch.equal(tp[n], before[n]) for n in SHAPES), i
        before = tp
        assert tst["mini_step"] == int(jst.mini_step) == (i + 1) % k
        assert int(tst["gradient_step"]) == int(jst.gradient_step)
    inner = tst["inner"]
    assert int(inner["count"]) == 1 and int(inner["notfinite"]) == 3
    assert not torch.equal(runs[k - 1][1]["a"], runs[0][1]["a"])


# ---- parameter selection on a tiny LM -------------------------------------

def _lm():
    kw = dict(vocab_size=23, emb=dict(embedding_dim=32),
              encoder=dict(d_model=32, num_heads=4, num_layers=2,
                           fdfwd_dim=64))
    jnet = JLM(cfg=JLMConfig(**kw))
    text = jnp.zeros((2, 5), jnp.int32)
    shapes = jax.eval_shape(jnet.init, {"params": jax.random.PRNGKey(0)},
                            text, jnp.array([5, 3]))
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes["params"])
    from speechain_tpu_torch.nn.lm import LanguageModelNet, LMConfig
    tnet = LanguageModelNet(LMConfig(**kw))
    tnet.load_state_dict(from_flax_variables({"params": params}),
                         strict=True)
    return params, tnet


def _drive(jtx, ttx, params, tnet, updates=3, seed=12):
    """``updates`` updates from the same seeded gradients on both sides,
    the port's parameters held to JAX's after the last; returns the names
    of the port parameters that never moved."""
    named = list(tnet.named_parameters())
    tp = [p.detach().clone() for _, p in named]
    start = [p.clone() for p in tp]
    names = [n for n, _ in named]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst, tst = jtx.init(jp), ttx.init(tp, names)
    jupdate = jax.jit(jtx.update)
    rng = np.random.default_rng(seed)
    for _ in range(updates):
        g = jax.tree_util.tree_map(
            lambda x: (0.5 * rng.standard_normal(x.shape)).astype(
                np.float32), params)
        upd, jst = jupdate(jax.tree_util.tree_map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        tg = from_flax_variables({"params": g})
        tst = ttx.update([tg[n] for n in names], tst, tp)
    want = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jp)})
    for n, p in zip(names, tp):
        close(p, want[n].numpy(), what=n)
    return {n for n, p, s in zip(names, tp, start) if torch.equal(p, s)}


def _flax_paths(params):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)}


@pytest.mark.parametrize("optim_type,sche", [("Adam", "noam"),
                                             ("AdamW", "exp")])
def test_updated_modules_select_the_reference_leaves(optim_type, sche):
    """``updated_modules`` by prefix ("encoder/layer_1"), by a path
    segment ("feed_forward") and by a name start ("embedding"): the
    frozen set is the flax labels' "freeze" set, the updated leaves match
    optax (clip and skip over the updated leaves only), the frozen ones
    stay bit-equal."""
    params, tnet = _lm()
    mods = ["encoder/layer_1", "feed_forward", "embedding"]
    kw = dict(sche_type=sche, optim_type=optim_type,
              optim_conf=dict(lr=1e-2), warmup_steps=3, grad_clip=1.0,
              updated_modules=mods)
    frozen = _drive(joptim.build_optimizer(**kw),
                    toptim.build_optimizer(**kw), params, tnet)
    paths = _flax_paths(params)
    want = {p for p in paths if not toptim.claims(p, mods)}
    got = {"/".join(flax_param_path(n, p.ndim))
           for n, p in tnet.named_parameters() if n in frozen}
    assert got == want and 0 < len(want) < len(paths)
    assert "encoder/layer_0/multihead_att/q_layer/kernel" in want
    assert "encoder/layer_0/feed_forward/in_layer/kernel" not in want


def test_optimizer_groups_match_the_reference():
    """Two groups (Adam on the encoder, SGD with momentum on what no
    group claims), each its own flat chain over its parameters; a third
    layout where every group names its modules freezes the rest; two
    groups claiming one parameter raise."""
    params, tnet = _lm()
    cfg = {"enc": dict(type="noam", conf=dict(
        updated_modules=["encoder"], optim_conf=dict(lr=1e-2),
        warmup_steps=3)),
           "rest": dict(type="exp", conf=dict(
               optim_type="SGD", optim_conf=dict(lr=0.1, momentum=0.9),
               decay_factor=0.5))}
    frozen = _drive(joptim.build_optimizers(cfg, steps_per_epoch=2,
                                            grad_clip=1.0),
                    toptim.build_optimizers(cfg, steps_per_epoch=2,
                                            grad_clip=1.0), params, tnet)
    assert not frozen
    cfg["rest"]["conf"]["updated_modules"] = ["postnet"]
    frozen = _drive(joptim.build_optimizers(cfg),
                    toptim.build_optimizers(cfg), params, tnet)
    assert {n.split(".")[0] for n in frozen} == {"embedding"}
    cfg["rest"]["conf"]["updated_modules"] = ["layer_0"]
    tp = [p for p in tnet.parameters()]
    with pytest.raises(AssertionError):
        joptim.build_optimizers(cfg).init(params)
    with pytest.raises(ValueError, match="overlapping"):
        toptim.build_optimizers(cfg).init(
            tp, [n for n, _ in tnet.named_parameters()])


def test_accumulating_lm_step_counts_every_call():
    """make_lm_step with accum_grad 2 on the port: ``state.step`` counts
    each call; the first call leaves every parameter bit-equal, the
    second moves them."""
    from speechain_tpu_torch.train.state import (init_train_state,
                                                 make_lm_step)
    _, tnet = _lm()
    tx = toptim.build_optimizer(optim_conf=dict(lr=1e-3), warmup_steps=3,
                                accum_grad=2)
    state = init_train_state(tnet, tx, device="cpu")
    step = make_lm_step(tnet, tx, device="cpu")
    text = torch.randint(1, 22, (2, 7), generator=torch.Generator()
                         .manual_seed(0))
    batch = dict(text=text, text_len=torch.tensor([7, 4]))
    gen = torch.Generator().manual_seed(1)
    start = [p.detach().clone() for p in tnet.parameters()]
    state, _ = step(state, batch, gen)
    assert int(state.step) == 1
    assert all(torch.equal(p, s) for p, s in zip(tnet.parameters(), start))
    state, _ = step(state, batch, gen)
    assert int(state.step) == 2 and state.opt_state["mini_step"] == 0
    assert not any(torch.equal(p, s)
                   for p, s in zip(tnet.parameters(), start))


def test_flatten_false_is_not_ported():
    with pytest.raises(NotImplementedError):
        toptim.build_optimizer(flatten=False)
