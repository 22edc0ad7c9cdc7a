"""The port's trainer (``repro_torch.models.lm.train_loss``,
``repro_torch.train.loop``, ``repro_torch.train.grad_compress``,
``repro_torch.launch.train``) against the reference's, on the CPU, at
``llama3_8b.reduced()`` in fp32 with the reference's weights carried
across (``convert.lm_params_from_numpy`` / ``train_state_from_numpy``).

Tolerances, normwise ``max|port - ref| <= tol * max|ref|``:

* the loss and its metrics 1e-5, every gradient leaf 1e-4 (the backward's
  products sum in other orders in XLA and PyTorch; measured <= 2.3e-6);
* one train step: ``mu``, ``nu`` and ``cov`` 1e-5, loss and gnorm
  1e-5; the parameters' update 1e-3 and the parameters 1e-4: Adam
  divides every entry by its own RMS, so an entry whose gradient is small
  against its leaf's largest carries the backward's round-off at its own
  scale (update measured <= 1.6e-4, parameters <= 1.4e-5: at lr 1e-2 a
  step moves the embedding by half its size; ``test_torch_optimizer``
  holds the update to 1e-4 on equal gradients);
* four steps of ``train()``: the loss history 1e-4;
* ``grad_compress``: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import lm as RL
from repro.train import grad_compress as RG
from repro.train import loop as RLOOP
from repro.train import optimizer as jopt
from repro_torch import convert, solvers
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as TL
from repro_torch.train import grad_compress as TG
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as topt

DENSE = ("llama3_8b", "starcoder2_3b", "nemotron_4_340b")


def close(got, want, tol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"normwise {err:.3e} > {tol:.0e}"


def leaves(tree):
    return convert.named_leaves(jax.tree.map(np.asarray, tree))


def tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    yield
    solvers.invalidate()


@pytest.fixture(scope="module")
def llama():
    rc, tc = ref_config("llama3_8b").reduced(), get_config("llama3_8b").reduced()
    params = RL.init_params(jax.random.PRNGKey(0), rc)
    return rc, tc, params, jax.tree.map(np.asarray, params)


def port_params(tree, cfg):
    return TL.train_params(convert.lm_params_from_numpy(tree, cfg, device="cpu"))


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_metrics_and_every_gradient_leaf_match_the_reference(arch):
    rc, tc = ref_config(arch).reduced(), get_config(arch).reduced()
    params = RL.init_params(jax.random.PRNGKey(1), rc)
    tree = jax.tree.map(np.asarray, params)
    batch = tokens(3, 40, seed=2)
    fn = jax.jit(jax.value_and_grad(lambda p, t: RL.train_loss(p, {"tokens": t}, rc), has_aux=True))
    (want, wmet), wgrad = fn(params, jnp.asarray(batch))
    tp = port_params(tree, tc)
    loss, met = TL.train_loss(tp, {"tokens": batch}, tc)
    grads = torch.autograd.grad(loss, list(tp.values()))
    close(loss, want, 1e-5)
    assert set(met) == set(wmet) == {"ce", "aux"}
    close(met["ce"], wmet["ce"], 1e-5)
    assert float(met["aux"]) == float(wmet["aux"]) == 0.0
    wg = leaves(wgrad)
    assert list(tp) == list(wg)  # the stacked layout, in the reference's leaf order
    for (name, p), g in zip(tp.items(), grads):
        assert g.shape == p.shape
        close(g, wg[name], 1e-4)


def test_train_loss_of_the_per_layer_model_equals_the_stacked_leaves(llama):
    _, tc, _, tree = llama
    model = convert.lm_params_from_numpy(tree, tc, device="cpu")
    batch = {"tokens": tokens(2, 24, seed=3)}
    a, _ = TL.train_loss(model, batch, tc)
    b, _ = TL.train_loss(TL.train_params(model), batch, tc)
    assert float(a) == float(b)


@pytest.mark.parametrize("seq_chunk", [7, 16, 37, 64])
def test_chunked_ce_with_a_ragged_last_chunk(seq_chunk):
    # S = 37 is no multiple of 7 or 16; a zero mask drops positions
    rng = np.random.default_rng(seq_chunk)
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 37)).astype(np.int32)
    mask = (rng.random((2, 37)) > 0.2).astype(np.float32)
    fn = jax.value_and_grad(
        lambda x, w: RL._chunked_ce(x, w, jnp.asarray(labels), jnp.asarray(mask), seq_chunk=seq_chunk),
        argnums=(0, 1))
    want, (gx, gw) = fn(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = TL._chunked_ce(tx, tw, torch.from_numpy(labels).long(), torch.from_numpy(mask),
                         seq_chunk=seq_chunk)
    got.backward()
    close(got, want, 1e-6)
    close(tx.grad, gx, 1e-5)
    close(tw.grad, gw, 1e-5)


# ---------------------------------------------------------------------------
# one train step, from the reference's state
# ---------------------------------------------------------------------------
def ref_optimizer(name):
    return jopt.get_optimizer(name, jopt.warmup_cosine(1e-2, 2, 10), max_grad_norm=1.0)


def port_optimizer(name):
    return lambda ps: topt.get_optimizer(name, ps, topt.warmup_cosine(1e-2, 2, 10), max_grad_norm=1.0)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_one_train_step_matches_the_reference_from_its_state(llama, name, microbatches):
    rc, tc, params, _ = llama
    jo = ref_optimizer(name)
    step = jax.jit(RLOOP.make_train_step(rc, jo, microbatches=microbatches))
    batch1, batch2 = tokens(4, 33, seed=5), tokens(4, 33, seed=6)
    p1, s1, _ = step(params, jo.init(params), {"tokens": jnp.asarray(batch1)})
    p2, s2, wmet = step(p1, s1, {"tokens": jnp.asarray(batch2)})
    state = {k: jax.tree.map(np.asarray, v) for k, v in s1.items()}
    named, opt = convert.train_state_from_numpy(jax.tree.map(np.asarray, p1), state, tc,
                                                port_optimizer(name), device="cpu")
    before = {k: p.detach().clone() for k, p in named.items()}
    step2 = TLOOP.make_train_step(tc, opt, microbatches=microbatches)
    met = step2(named, {"tokens": torch.from_numpy(batch2)})
    close(met["loss"], wmet["loss"], 1e-5)
    close(met["gnorm"], wmet["gnorm"], 1e-5)
    close(met["ce"], wmet["ce"], 1e-5)
    want, mu, nu = leaves(p2), leaves(s2["mu"]), leaves(s2["nu"])
    for k, p in named.items():
        st = opt.state[p]
        assert st["step"] == 2 == int(s2["step"])
        close(p, want[k], 1e-4)
        close(p.detach() - before[k], want[k] - leaves(p1)[k], 1e-3)
        close(st["mu"], mu[k], 1e-5)
        close(st["nu"], nu[k], 1e-5)
        if name == "ebv":
            cov = leaves(s2["cov"])[k]
            assert tuple(st["cov"].shape) == cov.shape
            if cov.size:
                close(st["cov"], cov, 1e-5)


def test_the_optimizers_decay_and_precondition_exactly_the_references_leaves():
    # the rules key on a leaf's shape: decay where ndim >= 2
    # (src/repro/train/optimizer.py:101), precondition where ndim == 2 and
    # min(shape) <= 1024 (:184-185).  The reference's stacked leaves give
    # one order-L group (the two stacked norm scales); per-layer leaves
    # would precondition wk/wv (4096 x 1024) and decay no norm scale.
    for layers in (4, 32):
        rc = ref_config("llama3_8b").replace(num_layers=layers)
        tc = get_config("llama3_8b").replace(num_layers=layers)
        ref = convert.named_leaves(jax.eval_shape(lambda k: RL.init_params(k, rc), jax.random.PRNGKey(0)))
        shapes = TL._train_shapes(tc)
        assert list(shapes) == list(ref)
        assert {k: s for k, (s, _) in shapes.items()} == {k: tuple(v.shape) for k, v in ref.items()}
        metas = [torch.empty(s, dtype=dt, device="meta") for s, dt in shapes.values()]
        opt = topt.EbvPreconditioned([torch.nn.Parameter(m) for m in metas])
        group = opt.param_groups[0]
        pre = {k for k, m in zip(shapes, metas) if opt.eligible(m, group)}
        ref_pre = {k for k, v in ref.items() if v.ndim == 2 and min(v.shape) <= 1024}
        assert pre == ref_pre == {"blocks.ln_attn.scale", "blocks.ln_mlp.scale"}
        orders = sorted(min(shapes[k][0]) for k in pre)
        assert orders == [layers, layers]  # one group of two order-L systems
        decayed = {k for k, m in zip(shapes, metas) if m.ndim >= 2}
        assert decayed == {k for k, v in ref.items() if v.ndim >= 2} == set(shapes) - {"ln_f.scale"}
    # the per-layer model's parameters would not give these rules
    per_layer = {n: tuple(p.shape) for n, p in TL.init_params(0, get_config("llama3_8b").reduced(),
                                                                 device="cpu").named_parameters()}
    assert any(len(s) == 2 and n.startswith("blocks.") and n.endswith("wk") for n, s in per_layer.items())


def test_the_ebv_step_keeps_a_covariance_exactly_where_the_reference_does(llama):
    rc, tc, params, tree = llama
    ref_cov = leaves(ref_optimizer("ebv").init(params)["cov"])
    named, opt = convert.train_state_from_numpy(tree, None, tc, port_optimizer("ebv"), device="cpu")
    with solvers.record_dispatches() as log:
        TLOOP.make_train_step(tc, opt)(named, {"tokens": torch.from_numpy(tokens(2, 16))})
    for k, p in named.items():
        assert tuple(opt.state[p]["cov"].shape) == ref_cov[k].shape, k
    # order 2 (the stacked norm scales, L = 2), then order 64 (embed, unembed)
    assert [(pr.op, pr.n, pr.batch) for pr, _ in log] == [
        ("factor", 2, 2), ("solve", 2, 2), ("factor", 64, 2), ("solve", 64, 2)]


# ---------------------------------------------------------------------------
# the driver and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_four_steps_of_train_match_the_reference(llama, name, capsys):
    rc, tc, params, tree = llama
    kw = dict(steps=4, seq_len=24, global_batch=4, warmup_steps=2, optimizer=name, learning_rate=1e-2)
    _, want = RLOOP.train(rc, RLOOP.TrainConfig(**kw), params=jax.tree.map(jnp.copy, params))
    got_params, got = TLOOP.train(tc, TLOOP.TrainConfig(**kw), params=port_params(tree, tc), device="cpu")
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2, 3]
    close([h["loss"] for h in got], [h["loss"] for h in want], 1e-4)
    close([h["gnorm"] for h in got], [h["gnorm"] for h in want], 1e-4)
    assert want[0]["loss"] > want[-1]["loss"]
    assert "[train] step     0 loss" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_the_launcher_trains_on_the_cpu(name, capsys):
    launch_train.main(["--arch", "llama3_8b", "--reduced", "--steps", "3", "--device", "cpu",
                       "--optimizer", name, "--seq-len", "32", "--batch", "4"])
    assert "[train] step     0 loss" in capsys.readouterr().out


def test_the_launcher_needs_a_card_or_the_cpu_and_no_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "llama3_8b", "--reduced", "--steps", "1"])
    for flags in (["--mesh", "2x4"], ["--devices", "8"]):
        with pytest.raises(SystemExit):
            launch_train.main(["--reduced", "--device", "cpu", *flags])


def test_other_families_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="A6"):
        TLOOP.make_batch_fn(get_config("qwen2_vl_2b").reduced(), TLOOP.TrainConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        TL.train_loss({}, {"tokens": tokens(1, 4)}, get_config("mamba2_1_3b").reduced())
    with pytest.raises(NotImplementedError, match="A7"):
        TG.compressed_psum({}, {}, mesh=None)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
def test_grad_compress_is_bit_for_bit_the_references():
    rng = np.random.default_rng(9)
    tree = {"w": (rng.standard_normal((6, 5)) * 3).astype(np.float32),
            "b": {"scale": rng.standard_normal((7,)).astype(np.float32)},
            "z": np.zeros((3,), np.float32)}
    for x in (tree["w"], tree["z"], np.array([0.5, -0.5, 1.5, 2.5], np.float32) * (127 / 2.5)):
        q, s = TG.quantize(torch.from_numpy(x))
        wq, ws = RG.quantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        assert q.dtype == torch.int8 and float(s) == float(ws)
        np.testing.assert_array_equal(TG.dequantize(q, s).numpy(), np.asarray(RG.dequantize(wq, ws)))
    err = TG.init_error(jax.tree.map(torch.from_numpy, tree))
    werr = RG.init_error(jax.tree.map(jnp.asarray, tree))
    for step in range(3):
        g = jax.tree.map(lambda x: x * (step + 1) + 0.1 * step, tree)
        tg = jax.tree.map(torch.from_numpy, g)
        q, s, err = TG.compress_with_feedback(tg, err)
        wq, ws, werr = RG.compress_with_feedback(jax.tree.map(jnp.asarray, g), werr)
        for a, b in ((q, wq), (s, ws), (err, werr)):
            la, lb = convert.named_leaves(a), leaves(b)
            assert list(la) == list(lb)
            for k in la:
                np.testing.assert_array_equal(la[k].numpy(), lb[k])
    assert TG.compression_ratio(jax.tree.map(torch.from_numpy, tree)) == RG.compression_ratio(tree)
