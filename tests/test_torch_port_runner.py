"""The port's runner (``speechain_tpu_torch.runner``), builders and
initializers against the JAX package's, on the CPU.

- ``merge_config`` and ``expand_infer_cfg`` equal JAX's on every exp_cfg;
- for every ASR and LM recipe, ``build_model``'s state-dict names and
  shapes equal those of the JAX net's init (``jax.eval_shape``, shapes
  only) through the weight bridge;
- ``init_state_dict`` against flax's ``net.init`` on small nets: the
  constants exactly equal, each random leaf of at least 4,096 elements
  within 5 % of flax's standard deviation, and the truncation bound of the
  truncated normals (the uniform's limit) kept on both sides;
- ``main(... --platform cpu)`` on a tiny conformer (CTC 0.3, float32,
  dropout 0, no SpecAugment) over a tone data set: the first step's loss,
  parameters and Adam first moment (the gradients) against JAX's
  ``make_arasr_step`` from the same weights, on batches of their real rows
  alone (``--batch_bucket 1``, see ``BUCKET``) (the loss 1e-4 relative; the
  parameters 1e-4 of max(1, max|p|), ``tests/test_torch_port_lm.py``'s
  rule, since a zero-initialized bias whose gradient is rounding noise
  moves by Adam's whole first step either way; the moments 1e-3 of each
  parameter's largest); 2 epochs bit-equal to 1 +
  ``--resume`` 1; ``--test`` hypotheses equal to a direct
  ``make_asr_decoder``; the ``--profile_steps`` trace; the averaged model
  refused, as the JAX package cannot decode from it either;
- an LM recipe's train and test (perplexity), its first step against
  JAX's ``make_lm_step``;
- each path not ported raises ``NotImplementedError``, and without a card
  the runner needs ``--platform cpu``.
"""

import glob
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechain_tpu import runner as jrunner
from speechain_tpu.builders import build_model as jbuild_model
from speechain_tpu.train.optim import build_optimizers as jbuild_optimizers
from speechain_tpu.train.state import init_train_state as jinit_state
from speechain_tpu.train.state import make_arasr_step as jmake_arasr
from speechain_tpu.train.state import make_lm_step as jmake_lm
from speechain_tpu.utils.yamlref import load_yaml as jload_yaml
from speechain_tpu_torch import runner
from speechain_tpu_torch.builders import build_model
from speechain_tpu_torch.train import state as tstate
from speechain_tpu_torch.utils.weights import (from_flax_variables,
                                               init_state_dict,
                                               to_flax_variables)
from tests.test_torch_port_data import make_wav_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP_CFGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "recipes", "**", "exp_cfg", "*.yaml"),
    recursive=True))
TRUNC = 0.87962566103423978     # flax's truncated normal's own std
# batches without all-padding rows: on such rows the JAX package's Pallas
# rel-pos VJP, which the port follows, and its XLA route (the CPU's)
# disagree (ROADMAP C); without them the two agree to rounding
BUCKET = ("--batch_bucket", "1")


def quick_jit(f):
    """``jax.jit(f)`` compiled at XLA's backend optimization level 0 at
    the first call (tiny sizes, where the optimizing passes are most of
    the cost)."""
    jf, compiled = jax.jit(f), []

    def run(*args):
        if not compiled:
            compiled.append(jf.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return compiled[0](*args)
    return run


def first_moments(net, flat):
    """Adam's flat first moment split into the port's parameter names."""
    out, offset = {}, 0
    for name, p in net.named_parameters():
        out[name] = flat[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
    assert offset == flat.numel()
    return out


def jax_first_moments(jstate):
    """JAX's flat first moment (its params' leaf order) as the port's
    state-dict names."""
    leaves, tree = jax.tree_util.tree_flatten(jstate.params)
    mu = np.asarray(jstate.opt_state["inner"][0].mu)
    ends = np.cumsum([x.size for x in leaves])
    assert ends[-1] == mu.size
    return from_flax_variables({"params": jax.tree_util.tree_unflatten(
        tree, [m.reshape(x.shape) for m, x in zip(np.split(mu, ends[:-1]),
                                                  leaves)])})


# ---- sources, configs, shapes --------------------------------------------

def test_port_sources_import_no_jax():
    """No module of the port and nothing in chip_smoke.py imports jax,
    flax, optax, orbax or the JAX package."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|"
                     r"speechain_tpu)(\.|\s|$)", re.M)
    files = glob.glob(os.path.join(REPO, "speechain_tpu_torch", "**",
                                   "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 60
    hits = [(os.path.relpath(f, REPO), m.group(0).strip())
            for f in files for m in bad.finditer(open(f).read())]
    assert not hits, hits


def test_every_exp_cfg_is_counted():
    assert len(EXP_CFGS) == 36


@pytest.mark.parametrize("path", EXP_CFGS)
def test_merge_config_matches(path):
    argv = ["--config", os.path.join(REPO, path), "--num_epochs", "3",
            "--result_path", "/nonexistent/exp"]
    got = runner.merge_config(runner.parse_args(argv))
    want = jrunner.merge_config(jrunner.parse_args(argv))
    assert got == want
    assert runner.expand_infer_cfg(got["infer_cfg"]) == \
        jrunner.expand_infer_cfg(want["infer_cfg"])


def test_expand_infer_cfg_forms():
    for cfg in ({}, None, dict(beam_size=4),
                dict(shared_args=dict(beam_size=8),
                     exclu_args=[dict(ctc_weight=0.2), dict(lm_weight=0.5,
                                                            ctc_weight=0.3)]),
                dict(a=dict(beam_size=1), b=dict(beam_size=2))):
        assert runner.expand_infer_cfg(cfg) == jrunner.expand_infer_cfg(cfg)


def _structure(model):
    """What a model block's parameters depend on: the family, the module
    conf and whether the ASR net has a CTC head."""
    customize = (model.get("model_conf") or {}).get("customize_conf") or {}
    return json.dumps([runner.model_family(model["model_type"]),
                       model.get("module_conf"),
                       bool(customize.get("ctc_weight"))], sort_keys=True,
                      default=str)


ASR_LM_RECIPES = sorted(
    p for p in EXP_CFGS if runner.model_family(jload_yaml(os.path.join(
        REPO, p))["train_cfg"]["model"]["model_type"]) in ("asr", "lm"))
SHAPES = {}
LAYER = re.compile(r"^(encoder|decoder)\.layer_(\d+)\.(.*)$")
TRACED_LAYERS = 2          # the JAX side's layers a stack (see below)


def _layers(names, stack):
    return len({m.group(2) for m in map(LAYER.match, names)
                if m and m.group(1) == stack})


def _jax_shapes(model, depth):
    """{state-dict name: shape} of the JAX net's init through the bridge,
    each layer stack cut to ``depth[stack]`` layers."""
    import copy
    model = copy.deepcopy(model)
    for stack, n in depth.items():
        conf = model["module_conf"][stack].setdefault("conf", {})
        conf["num_layers"] = n
    jnet, _, mtype = jbuild_model(model, 100)
    S = jax.ShapeDtypeStruct
    if runner.model_family(mtype) == "lm":
        args = (S((2, 8), jnp.int32), S((2,), jnp.int32))
    else:
        args = (S((2, 16000, 1), jnp.float32), S((2,), jnp.int32),
                S((2, 8), jnp.int32), S((2,), jnp.int32))
    shapes = jax.eval_shape(lambda *a: jnet.init(
        {"params": jax.random.PRNGKey(0)}, *a, train=False), *args)
    zeros = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.zeros((), x.dtype), x.shape), shapes)
    return {k: tuple(v.shape) for k, v in from_flax_variables(zeros).items()}


def test_every_asr_and_lm_recipe_is_counted():
    assert len(ASR_LM_RECIPES) == 27
    assert len({_structure(jload_yaml(os.path.join(REPO, p))["train_cfg"][
        "model"]) for p in ASR_LM_RECIPES}) == 11


@pytest.mark.parametrize("path", ASR_LM_RECIPES)
def test_build_model_shapes_match_jax(path):
    """The port's net of the recipe's model block (V 100, full depth)
    holds the state dict the weight bridge makes of the JAX net's init
    (``jax.eval_shape``), name for name and shape for shape. The JAX side
    is traced with each layer stack cut to its first 2 layers (every layer
    of a stack is built alike, ``nn/transformer.py`` and
    ``nn/conformer.py``), whose last layer's names and shapes stand for
    the stack's remaining ones; recipes of one structure share one trace.
    ``test_build_model_shapes_at_full_depth`` traces the slice's recipe
    uncut."""
    model = jload_yaml(os.path.join(REPO, path))["train_cfg"]["model"]
    with torch.device("meta"):
        net, _, _ = build_model(model, 100)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    full = {stack: _layers(got, stack) for stack in ("encoder", "decoder")
            if _layers(got, stack)}
    depth = {stack: min(n, TRACED_LAYERS) for stack, n in full.items()}
    key = _structure(model)
    if key not in SHAPES:
        SHAPES[key] = _jax_shapes(model, depth)
    want = {}
    for name, shape in SHAPES[key].items():
        m = LAYER.match(name)
        if m and int(m.group(2)) == depth[m.group(1)] - 1:
            for i in range(depth[m.group(1)] - 1, full[m.group(1)]):
                want[f"{m.group(1)}.layer_{i}.{m.group(3)}"] = shape
        else:
            want[name] = shape
    assert got == want


def test_build_model_shapes_at_full_depth():
    path = os.path.join(REPO, "recipes", "asr", "librispeech",
                        "train-clean-5", "exp_cfg",
                        "bpe1k_conformer-small.yaml")
    model = jload_yaml(path)["train_cfg"]["model"]
    with torch.device("meta"):
        net, _, _ = build_model(model, 100)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert _layers(got, "encoder") == 12 and _layers(got, "decoder") == 6
    assert got == _jax_shapes(model, dict(encoder=12, decoder=6))


# ---- init_state_dict against flax's init ----------------------------------

def _small_asr_model():
    return dict(
        model_type="ar_asr.ARASR",
        model_conf=dict(customize_conf=dict(ctc_weight=0.3)),
        module_conf=dict(
            frontend=dict(conf=dict(sr=8000, n_mels=16)), normalize=True,
            enc_prenet=dict(conf=dict(conv_dims=[8, 8], conv_batchnorm=True,
                                      lnr_dims=64)),
            encoder=dict(type="conformer", conf=dict(
                d_model=64, num_heads=2, num_layers=1, fdfwd_dim=256)),
            dec_emb=dict(conf=dict(embedding_dim=64)),
            decoder=dict(conf=dict(d_model=64, num_heads=2, num_layers=1,
                                   fdfwd_dim=256))))


def _small_moe_lm_model():
    return dict(model_type="lm.LM", module_conf=dict(
        emb=dict(conf=dict(embedding_dim=64)),
        encoder=dict(conf=dict(d_model=64, num_heads=2, num_layers=1,
                               fdfwd_dim=128, fdfwd_type="moe",
                               fdfwd_args=dict(num_experts=4)))))


@pytest.mark.parametrize("model", [_small_asr_model(),
                                   _small_moe_lm_model()],
                         ids=["conformer_asr", "moe_lm"])
def test_init_state_dict_matches_flax_init(model):
    V = 100
    jnet, _, mtype = jbuild_model(model, V)
    if runner.model_family(mtype) == "lm":
        args = (jnp.ones((2, 8), jnp.int32), jnp.array([8, 5]))
    else:
        args = (jnp.zeros((2, 4000, 1)), jnp.array([4000, 3000]),
                jnp.ones((2, 8), jnp.int32), jnp.array([8, 5]))
    variables = quick_jit(lambda *a: jnet.init(
        {"params": jax.random.PRNGKey(3)}, *a, train=False))(*args)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want = from_flax_variables(variables)
    flax_shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            variables.get("params", {}))[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        flax_shapes[tuple(keys)] = leaf.shape
    net, _, _ = build_model(model, V)
    got = init_state_dict(net, seed=11)
    assert sorted(got) == sorted(want)
    assert got.keys() == net.state_dict().keys()
    checked = {"constant": 0, "std": 0, "bound": 0}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype == torch.bool or bool((w == w.flatten()[0]).all()):
            assert torch.equal(g, w), name
            checked["constant"] += 1
            continue
        if w.numel() >= 4096:
            ratio = float(g.std()) / float(w.std())
            assert abs(ratio - 1.0) <= 0.05, (name, ratio)
            checked["std"] += 1
        leaf = name.rsplit(".", 1)[-1]
        path = [p for p in flax_shapes if ".".join(p[:-1]) ==
                name.rsplit(".", 1)[0] and p[-1] in (
                    "kernel", "pos_bias_u", "pos_bias_v", "expert_wi",
                    "expert_wo", "embedding") and (p[-1] == leaf or (
                        leaf == "weight" and p[-1] in ("kernel",
                                                       "embedding")))]
        assert len(path) == 1, (name, path)
        kind, shape = path[0][-1], flax_shapes[path[0]]
        if kind == "embedding":
            continue                      # a plain normal: no bound
        if kind.startswith("pos_bias"):
            limit = (6.0 / (shape[-2] + shape[-1])) ** 0.5
        else:
            limit = 2.0 * (1.0 / np.prod(shape[:-1])) ** 0.5 / TRUNC
        for x in (g, w):
            assert float(x.abs().max()) <= limit * (1 + 1e-6), name
        if g.numel() >= 4096:
            assert float(g.abs().max()) >= 0.9 * limit, name
        checked["bound"] += 1
    assert min(checked.values()) >= 2, checked


# ---- the runner on a tiny conformer ---------------------------------------

ASR_YAML = """
data_root: {root}
num_epochs: 2
seed: 7
report_per_steps: 2
best_model_num: 2
visual_snapshot_number: 0

data_cfg:
  train:
    type: block
    conf:
      dataset_type: speech_text
      dataset_conf:
        main_data:
          wav: !ref <data_root>/train/idx2wav
          text: !ref <data_root>/train/idx2text
      data_len: !ref <data_root>/train/idx2wav_len
      shuffle: True
      is_descending: True
      batch_len: 9000
  valid:
    type: abs
    conf:
      dataset_type: speech_text
      dataset_conf:
        main_data:
          wav: !ref <data_root>/valid/idx2wav
          text: !ref <data_root>/valid/idx2text
      data_len: !ref <data_root>/valid/idx2wav_len
      shuffle: False
      batch_size: 4
  test:
    type: abs
    conf:
      dataset_type: speech_text
      dataset_conf:
        main_data:
          wav: !ref <data_root>/test/idx2wav
          text: !ref <data_root>/test/idx2text
      data_len: !ref <data_root>/test/idx2wav_len
      shuffle: False
      batch_size: 4

train_cfg:
  model:
    model_type: ar_asr.ARASR
    model_conf:
      customize_conf:
        token_type: char
        token_path: !ref <data_root>/token
        ctc_weight: 0.3
        label_smoothing: 0.1
    module_conf:
      frontend:
        conf: {{sr: 8000, n_mels: 16, preemphasis: 0.97}}
      normalize: True
      enc_prenet:
        conf: {{conv_dims: [8, 8], conv_batchnorm: true,
               conv_activation: LeakyReLU, lnr_dims: 32}}
      encoder:
        type: conformer
        conf: {{d_model: 32, num_heads: 2, num_layers: 1, fdfwd_dim: 64,
               fdfwd_activation: GELU, depthwise_kernel_size: 7,
               layernorm_first: true, posenc_dropout: 0.0,
               fdfwd_dropout: 0.0, att_dropout: 0.0, res_dropout: 0.0}}
      dec_emb:
        conf: {{embedding_dim: 32}}
      decoder:
        conf: {{d_model: 32, num_heads: 2, num_layers: 1, fdfwd_dim: 64,
               emb_layernorm: true, emb_scale: false, posenc_dropout: 0.0,
               fdfwd_dropout: 0.0, att_dropout: 0.0, res_dropout: 0.0}}
  optim_sches:
    type: noam
    conf:
      optim_type: Adam
      optim_conf: {{lr: 0.002, betas: [0.9, 0.98], eps: 1.0e-9}}
      warmup_steps: 25000

infer_cfg:
  beam_size: 2
  temperature: 1.2
  ctc_weight: 0.2
"""


class Spy:
    """Wraps a step factory of ``train/state.py`` (looked up when the
    runner builds its steps): the first training step's batch, loss and
    the state after it (copies), unchanged otherwise."""

    def __init__(self, monkeypatch, name):
        real = getattr(tstate, name)
        self.first = None

        def make(*a, train=True, **kw):
            step = real(*a, train=train, **kw)

            def spied(st, batch, gen):
                st, m = step(st, batch, gen)
                if train and self.first is None:
                    self.first = dict(
                        batch={k: v.clone() for k, v in batch.items()},
                        loss=float(m["loss"]),
                        net={k: v.clone() for k, v in
                             st.net.state_dict().items()},
                        mu=st.opt_state["mu"].clone())
                return st, m
            return spied

        monkeypatch.setattr(tstate, name, make)


def run(cfg_path, result, *flags):
    return runner.main(["--config", str(cfg_path), "--result_path",
                        str(result), "--platform", "cpu", *flags])


@pytest.fixture(scope="module")
def asr(tmp_path_factory):
    root = tmp_path_factory.mktemp("asr")
    make_wav_set(str(root))
    cfg_path = root / "exp.yaml"
    cfg_path.write_text(ASR_YAML.format(root=root))
    mp = pytest.MonkeyPatch()
    try:
        # as on the card: no matplotlib and no tensorboardX, so each
        # snapshot fails, is logged, and training goes on (the reference's
        # rule); it also spares the tests their imports
        mp.setitem(sys.modules, "matplotlib", None)
        mp.setitem(sys.modules, "tensorboardX", None)
        spy = Spy(mp, "make_arasr_step")
        run(cfg_path, root / "straight", "--train", "--profile_steps", "1",
            *BUCKET)
        first = spy.first
        spy.first = None
        run(cfg_path, root / "resumed", "--train", "--num_epochs", "1",
            *BUCKET)
        run(cfg_path, root / "resumed", "--train", "--resume", *BUCKET)
        results = run(cfg_path, root / "straight", "--test")
    finally:
        mp.undo()
    return dict(root=root, cfg=cfg_path, first=first, results=results)


def _checkpoint(result):
    return (torch.load(result / "checkpoint" / "state.pt",
                       weights_only=True),
            json.loads((result / "checkpoint_meta.json").read_text()))


def test_two_epochs_equal_one_and_a_resumed_one(asr):
    """The straight 2-epoch run and 1 + --resume 1: net, optimizer state,
    step and the records bit-equal."""
    from tests.test_torch_port_checkpoint import assert_tree_equal
    (a, meta_a), (b, meta_b) = (_checkpoint(asr["root"] / r)
                                for r in ("straight", "resumed"))
    assert meta_a["epoch"] == meta_b["epoch"] == 2
    assert_tree_equal(a, b)
    assert meta_a["tracker"] == meta_b["tracker"]
    assert meta_a["monitor"]["epoch_records"] == \
        meta_b["monitor"]["epoch_records"]
    assert int(a["step"]) >= 4
    models = asr["root"] / "straight" / "models"
    registry = json.loads((models / "registry.json").read_text())
    assert registry["latest"] == 2 and sorted(registry["keep"]) == [1, 2]
    assert (models / "2_loss_average" / "model.pt").exists()


def test_first_step_matches_jax(asr):
    """The runner's first step from init_state_dict against JAX's
    make_arasr_step from the same weights on the same batch: loss,
    parameters (and statistics) after it, Adam's first moment."""
    first = asr["first"]
    cfg = runner.merge_config(runner.parse_args(["--config",
                                                 str(asr["cfg"])]))
    model = cfg["train_cfg"]["model"]
    net, _, _ = build_model(model, 11)
    start = init_state_dict(net, cfg["seed"])
    jnet, jcfg, _ = jbuild_model(model, 11)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       to_flax_variables(start))
    loader = runner.build_data(cfg["data_cfg"], "train", None)
    jtx = jbuild_optimizers(cfg["train_cfg"]["optim_sches"],
                            steps_per_epoch=len(loader),
                            grad_clip=cfg["grad_clip"])
    jstate = jinit_state(variables, jtx)
    batch = {k: jnp.asarray(v.numpy()) for k, v in first["batch"].items()}
    jstate, m = quick_jit(jmake_arasr(jnet, jcfg, jtx, axis_name=None))(
        jstate, batch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(first["loss"], float(m["loss"]), rtol=1e-4)
    want = from_flax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, **jstate.mutables}))
    assert sorted(want) == sorted(first["net"])
    for name, w in want.items():
        g = first["net"][name]
        if w.dtype == torch.bool:
            assert torch.equal(g, w), name
            continue
        err = float((g.float() - w).abs().max())
        assert err <= 1e-4 * max(1.0, float(w.abs().max())), (name, err)
    want_mu = jax_first_moments(jstate)
    got_mu = first_moments(net, first["mu"])
    scale = max(float(w.abs().max()) for w in want_mu.values())
    assert scale > 0
    for name, w in want_mu.items():
        err = float((got_mu[name] - w).abs().max())
        assert err <= max(1e-3 * float(w.abs().max()), 1e-6 * scale), (
            name, err)

    # the reference cannot decode from a parameters-only average either
    # (its average_models saves {"params": avg} alone)
    import flax
    with pytest.raises(flax.errors.ScopeCollectionNotFound):
        jnet.apply({"params": jstate.params}, batch["feat"],
                   batch["feat_len"], batch["text"], batch["text_len"],
                   train=False)


def test_test_hypotheses_equal_a_direct_decode(asr):
    from speechain_tpu_torch.infer.asr import make_asr_decoder
    from speechain_tpu_torch.utils.fileio import read_idx2data_file
    out_dir = asr["root"] / "straight" / "latest" / "test"
    for f in ("idx2hypo_text", "idx2cer", "idx2wer", "overall_results.md",
              "idx2text_confid", "idx2feat_token_len_ratio",
              "top30_max_wer.md"):
        assert (out_dir / f).exists(), f
    got = read_idx2data_file(str(out_dir / "idx2hypo_text"))
    cfg = runner.merge_config(runner.parse_args(["--config",
                                                 str(asr["cfg"])]))
    tok = runner._tokenizer_of(
        cfg["train_cfg"]["model"]["model_conf"]["customize_conf"])
    net, _, _ = build_model(cfg["train_cfg"]["model"], tok.vocab_size)
    state, _ = _checkpoint(asr["root"] / "straight")
    net.load_state_dict(state["net"], strict=True)
    decode = make_asr_decoder(net, device="cpu", beam_size=2,
                              temperature=1.2, ctc_weight=0.2)
    n = 0
    for b in runner.build_data(cfg["data_cfg"], "test", tok).epoch(0):
        out = decode(torch.from_numpy(b["feat"]),
                     torch.from_numpy(b["feat_len"]))
        for i in range(b["n_real"]):
            hyp = tok.tensor2text(out["hypo_text"][i][
                :int(out["hypo_text_len"][i])].numpy())
            assert got[b["indices"][i]].strip() == hyp.strip()
            n += 1
    assert n == len(got) == 4
    assert set(asr["results"]) == {"test"}


def test_profile_trace_is_written(asr):
    prof = asr["root"] / "straight" / "profile"
    assert (prof / "trace.json").stat().st_size > 1000
    summary = json.loads((prof / "summary.json").read_text())
    assert summary["steps"] == 1 and summary["wall_ms"] > 0
    assert summary["device"] == "cpu"
    assert (prof / "key_averages.txt").exists()


def test_average_model_is_refused_as_the_reference_cannot_decode_it(asr):
    with pytest.raises(ValueError, match="averaged parameters alone"):
        run(asr["cfg"], asr["root"] / "straight", "--test",
            "--test_model", "2_loss_average")


def test_epoch_model_decodes(asr):
    res = run(asr["cfg"], asr["root"] / "straight", "--test",
              "--test_model", "epoch_1")
    assert set(res) == {"test"} and 0.0 <= res["test"]["wer"]
    assert (asr["root"] / "straight" / "epoch_1" / "test" /
            "idx2hypo_text").exists()


# ---- the LM family --------------------------------------------------------

LM_YAML = """
data_root: {root}
num_epochs: 2
seed: 3
best_model_num: 2

data_cfg:
  train:
    type: block
    conf:
      dataset_type: speech_text
      dataset_conf:
        main_data:
          text: !ref <data_root>/train/idx2text
      data_len: !ref <data_root>/train/idx2text_len
      shuffle: True
      batch_len: 60
  valid:
    type: abs
    conf:
      dataset_type: speech_text
      dataset_conf:
        main_data:
          text: !ref <data_root>/valid/idx2text
      shuffle: False
      batch_size: 4
  test:
    type: abs
    conf:
      dataset_type: speech_text
      dataset_conf:
        main_data:
          text: !ref <data_root>/test/idx2text
      shuffle: False
      batch_size: 4

train_cfg:
  model:
    model_type: lm.LM
    model_conf:
      customize_conf:
        token_type: char
        token_path: !ref <data_root>/token
    module_conf:
      emb:
        conf: {{embedding_dim: 32, emb_scale: false}}
      encoder:
        conf: {{d_model: 32, num_heads: 2, num_layers: 1, fdfwd_dim: 64,
               posenc_dropout: 0.0, fdfwd_dropout: 0.0, att_dropout: 0.0,
               res_dropout: 0.0}}
  optim_sches:
    type: noam
    conf:
      optim_type: Adam
      optim_conf: {{betas: [0.9, 0.98], eps: 1.0e-9}}
      d_model: 32
      warmup_steps: 100
"""


def test_lm_train_and_test_match_jax(tmp_path, monkeypatch):
    """An LM recipe through the runner: the first step against JAX's
    make_lm_step (loss and Adam's first moment), the test set's
    perplexity from the latest and from the averaged model (an LM keeps
    no running statistics, so its average decodes)."""
    root = tmp_path
    make_wav_set(str(root))
    for split in ("train", "valid", "test"):
        lines = (root / split / "idx2text").read_text().split("\n")
        (root / split / "idx2text_len").write_text("\n".join(
            f"{ln.split(' ')[0]} {len(ln.split(' ', 1)[1])}"
            for ln in lines if ln) + "\n")
    cfg_path = root / "lm.yaml"
    cfg_path.write_text(LM_YAML.format(root=root))
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # as in `asr`
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    spy = Spy(monkeypatch, "make_lm_step")
    run(cfg_path, root / "exp", "--train")
    monkeypatch.undo()
    first = spy.first
    res = run(cfg_path, root / "exp", "--test")
    avg = run(cfg_path, root / "exp", "--test", "--test_model",
              "2_loss_average")
    for r in (res, avg):
        assert set(r) == {"test"} and np.isfinite(r["test"]["text_ppl"])
        assert r["test"]["text_ppl"] > 1.0
    assert (root / "exp" / "latest" / "test" / "overall_results.md").exists()

    cfg = runner.merge_config(runner.parse_args(["--config", str(cfg_path)]))
    model = cfg["train_cfg"]["model"]
    net, _, _ = build_model(model, 11)
    jnet, _, _ = jbuild_model(model, 11)
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_flax_variables(init_state_dict(net, cfg["seed"])))
    loader = runner.build_data(cfg["data_cfg"], "train", None)
    jtx = jbuild_optimizers(cfg["train_cfg"]["optim_sches"],
                            steps_per_epoch=len(loader),
                            grad_clip=cfg["grad_clip"])
    batch = {k: jnp.asarray(first["batch"][k].numpy())
             for k in ("text", "text_len")}
    jstate, m = quick_jit(jmake_lm(jnet, jtx, axis_name=None))(
        jinit_state(variables, jtx), batch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(first["loss"], float(m["loss"]), rtol=1e-4)
    want_mu = jax_first_moments(jstate)
    got_mu = first_moments(net, first["mu"])
    scale = max(float(w.abs().max()) for w in want_mu.values())
    for name, w in want_mu.items():
        err = float((got_mu[name] - w).abs().max())
        assert err <= max(1e-3 * float(w.abs().max()), 1e-6 * scale), (
            name, err)


# ---- what is not ported ---------------------------------------------------

def _set(path, value):
    """An edit of the resolved exp_cfg dict: ``value`` at ``path``."""
    def edit(cfg):
        node = cfg
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value(node.get(path[-1])) if callable(value) \
            else value
    return edit


_CUSTOM = ("train_cfg", "model", "model_conf", "customize_conf")
NOT_PORTED = {
    "mesh": (["--train", "--mesh", "data=2"], None),
    "mesh_model": (["--train", "--mesh", "data=1,model=2"], None),
    "parallel_block": (["--train"], _set(("train_cfg", "parallel"),
                                         dict(data=1, fsdp=1))),
    "coordinator": (["--train", "--coordinator", "localhost:1234",
                     "--host_id", "0"], None),
    "num_hosts": (["--train", "--num_hosts", "2"], None),
    "n_devices": (["--train", "--n_devices", "2"], None),
    "multi_loader": (["--train"], _set(("data_cfg", "train"),
                                       lambda t: dict(asr=t, more=t))),
    "weight_quant": (["--test"], _set(("infer_cfg", "weight_quant"),
                                      "int8")),
    "orbax_pretrained": (["--train"], _set(
        ("train_cfg", "model", "model_conf", "pretrained_model"),
        dict(path="{orbax}"))),
    "orbax_lm": (["--test"], lambda cfg: cfg["infer_cfg"].update(
        lm_weight=0.5, lm_model_cfg="{lm_cfg}", lm_model_path="{orbax}")),
    "artts_train": (["--train"], _set(("train_cfg", "model", "model_type"),
                                      "ar_tts.ARTTS")),
    "fastspeech2_test": (["--test"], _set(
        ("train_cfg", "model", "model_type"), "nar_tts.FastSpeech2")),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_paths_raise(asr, tmp_path, case):
    """Each path a later ROADMAP item ports raises NotImplementedError
    naming it."""
    import yaml
    flags, edit = NOT_PORTED[case]
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    cfg_path = asr["cfg"]
    if edit is not None:
        cfg = runner.merge_config(runner.parse_args(["--config",
                                                     str(cfg_path)]))
        exp = {k: cfg[k] for k in ("data_cfg", "train_cfg", "infer_cfg",
                                   "seed", "num_epochs")}
        edit(exp)
        text = yaml.safe_dump(exp).replace("'{orbax}'", str(orbax)) \
            .replace("'{lm_cfg}'", str(asr["cfg"]))
        cfg_path = tmp_path / "edited.yaml"
        cfg_path.write_text(text)
    result = tmp_path / "exp"
    if flags == ["--test"]:
        import shutil
        shutil.copytree(asr["root"] / "straight" / "checkpoint",
                        result / "checkpoint")
    with pytest.raises(NotImplementedError, match="ROADMAP A[678]"):
        run(cfg_path, result, *flags)


def test_the_runner_needs_a_card_unless_cpu_is_asked(asr, tmp_path):
    argv = ["--config", str(asr["cfg"]), "--result_path",
            str(tmp_path / "exp"), "--train"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.main(argv)
    with pytest.raises(ValueError, match="platform"):
        runner.main(argv + ["--platform", "tpu"])
