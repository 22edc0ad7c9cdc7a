"""The port's checkpoints (``repro_torch.ckpt.manager``) on the CPU: the
reference's layout and flat paths, pruning, atomic and asynchronous
saves, bfloat16 round trips, a checkpoint of either package restored by
the other, and a resumed training run against an uninterrupted one.

Tolerances: a round trip is bit for bit; the reference's run resumed in
the port against the reference's own resumed run, normwise 1e-4 (the
loss), 1e-4 (the parameters; ``test_torch_train`` explains both); the
port's resumed run against its uninterrupted run, bit for bit (the same
CPU arithmetic from the same stored bits).
"""
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as RefManager
from repro.configs.base import get_config as ref_config
from repro.models import lm as RL
from repro.train import loop as RLOOP
from repro_torch import convert, solvers
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.models import lm as TL
from repro_torch.train import loop as TLOOP


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    yield
    solvers.invalidate()


def tree(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return ({"w": torch.randn(3, 4, generator=g).to(dtype), "b": {"scale": torch.randn(5, generator=g)}},
            {"step": torch.tensor(7, dtype=torch.int32), "mu": [torch.randn(2, generator=g), None],
             "nu": (torch.zeros(0, 0),)})


def assert_bitwise(got, want):
    from repro_torch.ckpt.manager import _flatten

    g, w = _flatten(got), _flatten(want)
    assert list(g) == list(w)
    for k in g:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k].view(torch.int16) if g[k].dtype == torch.bfloat16 else g[k],
                           w[k].view(torch.int16) if w[k].dtype == torch.bfloat16 else w[k]), k


def test_round_trip_keeps_the_references_layout_and_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = tree(0)
    for step in (1, 2, 3):
        mgr.save(step, tree(step), extra={"data": {"step": step, "seed": 0}})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000003"]
    assert sorted(os.listdir(tmp_path / "step_000000003")) == ["arrays.npz", "manifest.json"]
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json").read_text())
    assert manifest["step"] == 3 and manifest["extra"] == {"data": {"step": 3, "seed": 0}}
    # the reference's flat paths: dict keys sorted, sequence positions, None dropped
    assert list(manifest["arrays"]) == ["0/b/scale", "0/w", "1/mu/0", "1/nu/0", "1/step"]
    assert manifest["arrays"]["1/step"] == {"shape": [], "dtype": "int32"}
    got, extra, step = mgr.restore(t)
    assert step == 3 and extra["data"]["step"] == 3
    assert isinstance(got, tuple) and isinstance(got[1]["nu"], tuple) and got[1]["mu"][1] is None
    assert_bitwise(got, tree(3))
    got2, _, _ = mgr.restore(t, step=2)
    assert_bitwise(got2, tree(2))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(t)


def test_a_save_that_dies_leaves_the_newest_checkpoint_whole(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree(1))

    def crash(*args, **kwargs):
        raise OSError("disk gone")

    monkeypatch.setattr(np, "savez", crash)
    with pytest.raises(OSError):
        mgr.save(2, tree(2))
    monkeypatch.undo()
    # the half-written step_2.tmp is not a checkpoint
    assert (tmp_path / "step_000000002.tmp").exists()
    assert mgr.all_steps() == [1]
    got, _, step = mgr.restore(tree(0))
    assert step == 1
    assert_bitwise(got, tree(1))
    mgr.save(2, tree(2))  # a later save of the step replaces the leftover
    assert mgr.all_steps() == [1, 2] and not (tmp_path / "step_000000002.tmp").exists()


def test_an_asynchronous_save_copies_the_tree_before_it_returns(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree(4)
    want = tree(4)
    gate = threading.Event()
    real = np.savez

    def slow(*args, **kwargs):
        gate.wait(5)
        real(*args, **kwargs)

    np.savez, saved = slow, np.savez
    try:
        mgr.save(5, t, blocking=False)
        t[0]["w"].add_(1.0)  # the step loop goes on changing the tree in place
        assert mgr.all_steps() == []
        gate.set()
        mgr.wait()
    finally:
        np.savez = saved
    assert mgr.all_steps() == [5]
    assert_bitwise(mgr.restore(t)[0], want)


def test_bfloat16_round_trips_as_its_bits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree(6, torch.bfloat16)
    t[0]["w"][0, 0] = float("nan")
    t[0]["w"][0, 1] = float("-inf")
    mgr.save(1, t)
    manifest = json.loads((tmp_path / "step_000000001" / "manifest.json").read_text())
    assert manifest["arrays"]["0/w"] == {"shape": [3, 4], "dtype": "bfloat16"}
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as data:
        assert data["0/w"].dtype == np.uint16
    got, _, _ = mgr.restore(t)
    assert got[0]["w"].dtype == torch.bfloat16
    assert_bitwise(got, t)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree(8)
    mgr.save(3, t, extra={"data": {"step": 3, "seed": 1}})
    got, extra, step = RefManager(str(tmp_path)).restore(jax.tree.map(np.asarray, (
        {"w": 0, "b": {"scale": 0}}, {"step": 0, "mu": [0, None], "nu": (0,)})))
    assert step == 3 and extra == {"data": {"step": 3, "seed": 1}}
    np.testing.assert_array_equal(got[0]["w"], t[0]["w"].numpy())
    np.testing.assert_array_equal(got[1]["mu"][0], t[1]["mu"][0].numpy())
    assert int(got[1]["step"]) == 7


# ---------------------------------------------------------------------------
# training resumed from a checkpoint
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def llama():
    rc, tc = ref_config("llama3_8b").reduced(), get_config("llama3_8b").reduced()
    params = RL.init_params(jax.random.PRNGKey(0), rc)
    return rc, tc, params, jax.tree.map(np.asarray, params)


def kw(name, steps, ckpt_dir, ckpt_every=2):
    return dict(steps=steps, seq_len=16, global_batch=4, warmup_steps=2, optimizer=name,
                learning_rate=1e-2, ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every)


@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_a_reference_checkpoint_resumes_in_the_port_to_the_references_next_step(llama, tmp_path,
                                                                               name, capsys):
    rc, tc, params, tree_ = llama
    RLOOP.train(rc, RLOOP.TrainConfig(**kw(name, 4, tmp_path / "ref")),
                params=jax.tree.map(jnp.copy, params))
    shutil.rmtree(tmp_path / "ref" / "step_000000004")  # as if it died after step 2's save
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    cfg = kw(name, 4, tmp_path / "ref")
    want_params, want = RLOOP.train(rc, RLOOP.TrainConfig(**cfg), params=jax.tree.map(jnp.copy, params))
    cfg["ckpt_dir"] = str(tmp_path / "port")
    got_params, got = TLOOP.train(tc, TLOOP.TrainConfig(**cfg), params=TL.train_params(
        convert.lm_params_from_numpy(tree_, tc, device="cpu")), device="cpu")
    out = capsys.readouterr().out
    assert out.count("[train] resumed from step 2") == 2
    assert [h["step"] for h in got] == [h["step"] for h in want] == [2, 3]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
    wl = convert.named_leaves(jax.tree.map(np.asarray, want_params))
    for k, p in got_params.items():
        w = wl[k]
        assert np.abs(p.detach().numpy() - w).max() <= 1e-4 * np.abs(w).max(), k


@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_a_resumed_run_equals_the_uninterrupted_run_bit_for_bit(tmp_path, name, capsys):
    cfg = get_config("llama3_8b").reduced()
    start = TL.train_params(TL.init_params(3, cfg, device="cpu"))
    copy = lambda: {k: torch.nn.Parameter(v.detach().clone()) for k, v in start.items()}
    whole, want = TLOOP.train(cfg, TLOOP.TrainConfig(**kw(name, 6, tmp_path / "a")), params=copy(),
                              device="cpu")
    # the same command, interrupted after step 4's checkpoint, run again
    TLOOP.train(cfg, TLOOP.TrainConfig(**kw(name, 6, tmp_path / "b")), params=copy(), device="cpu")
    shutil.rmtree(tmp_path / "b" / "step_000000006")
    resumed, got = TLOOP.train(cfg, TLOOP.TrainConfig(**kw(name, 6, tmp_path / "b")), params=copy(),
                               device="cpu")
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert [h["step"] for h in got] == [4, 5]
    assert [h["loss"] for h in got] == [h["loss"] for h in want[4:]]
    for k in whole:
        assert torch.equal(resumed[k], whole[k]), k
    a = CheckpointManager(str(tmp_path / "a")).restore(TLOOP.state_tree(whole, _opt(name, whole)))[0]
    b = CheckpointManager(str(tmp_path / "b")).restore(TLOOP.state_tree(whole, _opt(name, whole)))[0]
    assert_bitwise(a, b)


def _opt(name, params):
    from repro_torch.train import optimizer as topt

    return topt.get_optimizer(name, list(params.values()), 1e-3)
