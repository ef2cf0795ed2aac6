"""The port's checkpoint manager and best-model tracker
(``speechain_tpu_torch/train/checkpoint.py``), on the CPU.

Save and restore round-trip a tiny LM's train state (net, the optimizer
state of Adam under ``MultiSteps`` and of a grouped optimizer, the step)
bit for bit; a save whose commit never ran leaves the previous
checkpoint whole; ``prune_epochs`` keeps what it is told; the average of
N epoch models is the float64 mean cast to float32, of the parameters
alone; and the tracker decides as the JAX package's ``BestModelTracker``
over seeded metric sequences.
"""

import os

import numpy as np
import pytest
import torch

from speechain_tpu.train.checkpoint import BestModelTracker as JTracker
from speechain_tpu_torch.nn.lm import LanguageModelNet, LMConfig
from speechain_tpu_torch.train.checkpoint import (BestModelTracker,
                                                  CheckpointManager,
                                                  load_model)
from speechain_tpu_torch.train.optim import build_optimizer, build_optimizers
from speechain_tpu_torch.train.state import init_train_state, make_lm_step
from speechain_tpu_torch.utils.weights import init_state_dict

V = 13


def tiny_lm(seed=0):
    net = LanguageModelNet(LMConfig(
        vocab_size=V, emb=dict(embedding_dim=16),
        encoder=dict(d_model=16, num_heads=2, num_layers=1, fdfwd_dim=32)))
    net.load_state_dict(init_state_dict(net, seed), strict=True)
    return net


def batch(seed=0):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, V - 1, (3, 7)).astype(np.int32)
    text[:, 0] = V - 1
    return dict(text=torch.from_numpy(text),
                text_len=torch.tensor([7, 5, 3], dtype=torch.int32))


OPTIMIZERS = {
    "adam": lambda: build_optimizer(warmup_steps=10),
    "multisteps": lambda: build_optimizer(warmup_steps=10, accum_grad=2),
    "grouped": lambda: build_optimizers(
        {"enc": dict(type="noam", conf=dict(
            warmup_steps=10, updated_modules=["encoder"])),
         "rest": dict(type="exp", conf=dict(optim_conf=dict(lr=1e-3)))}),
}


def trained(tx_name, steps=3, seed=0):
    net = tiny_lm(seed)
    tx = OPTIMIZERS[tx_name]()
    state = init_train_state(net, tx, device="cpu")
    step = make_lm_step(net, tx, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for i in range(steps):
        state, _ = step(state, batch(i), gen)
    return state, tx


def assert_tree_equal(a, b):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("tx_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("async_save", [True, False])
def test_train_state_round_trip(tmp_path, tx_name, async_save):
    """Net, optimizer state and step restored bit for bit into a fresh
    state of another init; the metadata with them; the step after the
    restore equal to the step after the save."""
    state, tx = trained(tx_name)
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    meta = dict(epoch=4, monitor=dict(step=3), tracker=None)
    mgr.save_train_state(state, extra=meta)
    assert mgr.has_checkpoint()
    mgr.close()

    other = init_train_state(tiny_lm(seed=5), OPTIMIZERS[tx_name](),
                             device="cpu")
    restored, got_meta = CheckpointManager(str(tmp_path)) \
        .restore_train_state(other)
    assert got_meta == meta
    assert_tree_equal(state.net.state_dict(), restored.net.state_dict())
    assert_tree_equal(state.opt_state, restored.opt_state)
    assert int(restored.step) == int(state.step) == 3

    gen_a, gen_b = (torch.Generator().manual_seed(9) for _ in range(2))
    a, _ = make_lm_step(state.net, tx, device="cpu")(state, batch(7), gen_a)
    b, _ = make_lm_step(restored.net, tx, device="cpu")(restored, batch(7),
                                                        gen_b)
    assert_tree_equal(a.net.state_dict(), b.net.state_dict())


def test_uncommitted_save_leaves_the_previous_checkpoint(tmp_path):
    """The second save's write lands in ``checkpoint.tmp`` but its commit
    never runs (the process ends before the next save, restore or close):
    a new manager restores the first state whole, and its next save
    replaces the stale tmp."""
    first, tx = trained("adam", steps=1)
    want = {k: v.clone() for k, v in first.net.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_train_state(first, extra=dict(epoch=1))
    mgr.close()
    second, _ = trained("adam", steps=3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_train_state(second, extra=dict(epoch=2))
    mgr._writer.join()                 # the write ends; no commit runs
    assert os.path.exists(tmp_path / "checkpoint.tmp" / "state.pt")

    other = init_train_state(tiny_lm(seed=5), OPTIMIZERS["adam"](),
                             device="cpu")
    fresh = CheckpointManager(str(tmp_path))
    restored, meta = fresh.restore_train_state(other)
    assert meta == dict(epoch=1) and int(restored.step) == 1
    assert_tree_equal(want, restored.net.state_dict())
    fresh.save_train_state(second, extra=dict(epoch=2))
    fresh.close()
    assert not os.path.exists(tmp_path / "checkpoint.tmp")
    assert CheckpointManager(str(tmp_path)).restore_train_state(
        other)[1] == dict(epoch=2)


def test_prune_epochs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    net = tiny_lm()
    for e in range(1, 6):
        mgr.save_epoch_model(e, net)
    mgr.prune_epochs([2, 5])
    names = sorted(n for n in os.listdir(mgr.models_dir)
                   if n.startswith("epoch_"))
    assert names == ["epoch_2", "epoch_5"]
    assert_tree_equal(mgr.restore_epoch_model(5), net.state_dict())


def test_average_models_is_the_float64_mean(tmp_path):
    """``average_models`` of three epoch models: each parameter the
    float64 sum over the epochs divided by 3, cast to float32, saved under
    ``models/3_loss_average`` without the buffers."""
    mgr = CheckpointManager(str(tmp_path))
    nets = [tiny_lm(seed) for seed in (1, 2, 3)]
    for e, net in enumerate(nets, 1):
        for p in net.parameters():       # values that round differently
            p.data.add_(torch.rand(p.shape, generator=torch.Generator()
                                   .manual_seed(e)) * 1e-3)
        mgr.save_epoch_model(e, net)
    names = [n for n, _ in nets[0].named_parameters()]
    avg = mgr.average_models([3, 1, 2], names, name="loss_average")
    mgr.close()
    saved = load_model(os.path.join(mgr.models_dir, "3_loss_average"))
    assert sorted(saved) == sorted(names)
    for n in names:
        want = (sum(dict(net.named_parameters())[n].detach().double()
                    for net in nets) / 3.0).float()
        assert saved[n].dtype == torch.float32
        assert torch.equal(saved[n], want), n
        assert torch.equal(avg[n], want)
    with pytest.raises(ValueError):
        mgr.average_models([], names)


def _metric_runs():
    cases = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        rules = [("loss", "min", int(rng.integers(1, 4)))]
        if seed % 2:
            rules.append(("accuracy", "max", 2))
        cases.append(dict(
            seed=seed, rules=rules, last_n=int(rng.integers(1, 3)),
            patience=int(rng.integers(2, 4)),
            threshold=[0.0, 0.05][seed % 2],
            metrics=[dict(loss=float(rng.uniform(1, 3)),
                          accuracy=float(rng.uniform(0, 1)))
                     for _ in range(9)]))
    cases.append(dict(seed=9, rules=[], last_n=1, patience=1, threshold=0.0,
                      metrics=[dict(loss=3.0), dict(loss=2.0), dict(loss=2.0),
                               {}, dict(loss=1.0)]))
    return cases


@pytest.mark.parametrize("case", _metric_runs(), ids=lambda c: f"s{c['seed']}")
def test_tracker_decides_as_the_reference(case):
    """Retention, best lists, early stopping and the state dict, epoch by
    epoch, and after a state-dict round trip half-way."""
    kw = dict(last_n=case["last_n"],
              early_stopping_patience=case["patience"],
              early_stopping_threshold=case["threshold"])
    j, t = JTracker(case["rules"], **kw), BestModelTracker(case["rules"],
                                                           **kw)
    for epoch, m in enumerate(case["metrics"], 1):
        assert t.update(epoch, m) == j.update(epoch, m)
        assert t.state_dict() == j.state_dict()
        if epoch == 4:
            t = BestModelTracker(case["rules"], **kw)
            t.load_state_dict(j.state_dict())
    assert t.update(len(case["metrics"]) + 1, {}) == \
        j.update(len(case["metrics"]) + 1, {})
