"""The port's optimizers against the JAX package's, on the CPU.

The reference takes its first step from ``init``; its parameters and
state are then carried into the port with ``repro_torch.convert``, and
both take the next three steps on the same numpy gradients.

Tolerances: state (``mu``, ``nu``, ``cov``) and parameters normwise
``1e-5`` of their largest entry (fp32 elementwise updates, sums in other
orders).  Each step's parameter *update* ``p_new - p_old`` normwise
``1e-4``: the EbV step solves ``(C/tau + lambda I) P = G``, whose
condition number (up to ~1/lambda = 1e3) multiplies the two frameworks'
fp32 round-off; measured <= 6.4e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch import convert, solvers, train
from repro_torch.train import optimizer as topt

SHAPES = {
    "w1": (16, 24),    # order 16, covariance on the left
    "w2": (40, 16),    # order 16 on the right: one group with w1, RHS padded 24 -> 40
    "w3": (8, 12),     # order 8, a group of its own
    "bias": (12,),     # 1-D: AdamW, no weight decay
    "stack": (2, 8, 8),  # 3-D: AdamW
    "wide": (20, 30),  # min(shape) > max_precond_dim: AdamW
}
KW = dict(max_precond_dim=16, solver_block=8)


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def close(port, want, tol=1e-5):
    port = np.asarray(port, np.float64)
    want = np.asarray(want, np.float64)
    assert port.shape == want.shape
    err = np.abs(port - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"normwise error {err:.2e} > {tol:.0e}"


def leaves(t):
    return convert.named_leaves(jax.tree.map(np.asarray, t))


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    yield
    solvers.invalidate()


def reference(name, schedule, **kw):
    return (jopt.adamw(schedule, **kw) if name == "adamw"
            else jopt.ebv_preconditioned(schedule, **KW, **kw))


def port(name, lr, **kw):
    return ((lambda ps: topt.AdamW(ps, lr=lr, **kw)) if name == "adamw"
            else (lambda ps: topt.EbvPreconditioned(ps, lr=lr, **KW, **kw)))


def set_grads(named, grads):
    for k, p in named.items():
        p.grad = torch.from_numpy(grads[k])


@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_three_steps_match_the_reference_from_its_state(name):
    schedule = jopt.warmup_cosine(1e-2, 2, 10)
    jo = reference(name, schedule)
    params = jax.tree.map(jnp.asarray, tree(0, 0.1))
    state = jo.init(params)
    params, state = jo.update(jax.tree.map(jnp.asarray, tree(1)), state, params)
    npstate = {k: jax.tree.map(np.asarray, v) for k, v in state.items() if k != "gnorm"}
    named, opt = convert.optimizer_from_numpy(jax.tree.map(np.asarray, params), npstate,
                                              port(name, topt.warmup_cosine(1e-2, 2, 10)),
                                              device="cpu")
    for step in range(2, 5):
        before = leaves(params)
        grads = tree(step)
        params, state = jo.update(jax.tree.map(jnp.asarray, grads), state, params)
        set_grads(named, grads)
        opt.step()
        want, mu, nu = leaves(params), leaves(state["mu"]), leaves(state["nu"])
        for k, p in named.items():
            st = opt.state[p]
            assert st["step"] == step == int(state["step"])
            close(p.detach(), want[k])
            close(p.detach().numpy() - before[k], want[k] - before[k], 1e-4)
            close(st["mu"], mu[k])
            close(st["nu"], nu[k])
            if name == "ebv":
                cov = leaves(state["cov"])[k]
                assert tuple(st["cov"].shape) == cov.shape
                if cov.size:
                    close(st["cov"], cov)
        close(opt.last_grad_norm, np.asarray(state["gnorm"]))


@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_a_fresh_optimizer_takes_the_references_first_step(name):
    jo = reference(name, jopt.constant_lr(3e-3), max_grad_norm=None)
    params = jax.tree.map(jnp.asarray, tree(5, 0.1))
    grads = tree(6)
    want, _ = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(params), params)
    named, opt = convert.optimizer_from_numpy(jax.tree.map(np.asarray, params), None,
                                              port(name, 3e-3, max_grad_norm=None), device="cpu")
    set_grads(named, grads)
    opt.step()
    for k, w in leaves(want).items():
        close(named[k].detach(), w)


def test_one_batched_dispatch_per_order_group():
    named, opt = convert.optimizer_from_numpy(tree(7, 0.1), None, port("ebv", 1e-2), device="cpu")
    set_grads(named, tree(8))
    with solvers.record_dispatches() as log:
        opt.step()
    # order 8 (w3 alone), then order 16 (w1 and w2, w1's RHS padded to 40 columns)
    assert [(p.op, p.structure, p.n, p.batch, p.rhs, name) for p, name in log] == [
        ("factor", "batched_dense", 8, 1, 0, "cuda_vmem"),
        ("solve", "batched_dense", 8, 1, 12, "cuda_vmem"),
        ("factor", "batched_dense", 16, 2, 0, "cuda_vmem"),
        ("solve", "batched_dense", 16, 2, 40, "cuda_vmem"),
    ]
    # the enriched factor would admit cuda_inverted; the static choice is the kernel
    assert all(p.enriched for p, _ in log if p.op == "solve")


def test_forced_solver_impl_matches_the_reference_mirror():
    jo = jopt.ebv_preconditioned(jopt.constant_lr(1e-2), solver_impl="xla", **KW)
    params = jax.tree.map(jnp.asarray, tree(9, 0.1))
    grads = tree(10)
    want, _ = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(params), params)
    named, opt = convert.optimizer_from_numpy(jax.tree.map(np.asarray, params), None,
                                              port("ebv", 1e-2, solver_impl="torch"), device="cpu")
    set_grads(named, grads)
    with solvers.record_dispatches() as log:
        opt.step()
    assert {name for _, name in log} == {"torch"}
    for k, w in leaves(want).items():
        close(named[k].detach(), w)


def test_a_whisper_like_group_is_one_wide_dispatch():
    # embed (V, d) and unembed (d, V) at reduced width: one order-d group of
    # two systems whose RHS is (2, d, V), wider than the reference's 4n cap
    rng = np.random.default_rng(11)
    v, d = 300, 16
    params = {"embed": rng.standard_normal((v, d)).astype(np.float32) * 0.02,
              "unembed": rng.standard_normal((d, v)).astype(np.float32) * 0.02,
              "ln_f": {"scale": np.ones((d,), np.float32)}}
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    jo = jopt.ebv_preconditioned(jopt.constant_lr(1e-3))
    jp = jax.tree.map(jnp.asarray, params)
    want, _ = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(jp), jp)
    named, opt = convert.optimizer_from_numpy(params, None,
                                              lambda ps: topt.EbvPreconditioned(ps, lr=1e-3),
                                              device="cpu")
    assert list(named) == ["embed", "ln_f.scale", "unembed"]
    for k, g in convert.named_leaves(grads).items():
        named[k].grad = torch.from_numpy(g)
    with solvers.record_dispatches() as log:
        opt.step()
    assert [(p.n, p.batch, p.rhs, name) for p, name in log] == [
        (d, 2, 0, "cuda_vmem"), (d, 2, v, "cuda_vmem")]
    for k, w in leaves(want).items():
        close(named[k].detach(), w)


@pytest.mark.parametrize("tolerance", ["auto", 1e-3, 0.0])
def test_solve_tolerance_raises_until_the_accuracy_tiers_arrive(tolerance):
    # the accuracy tiers have arrived: solve_tolerance is taken as the
    # reference takes it ("auto" = max(1e-6, (1 - b2) / 10)) and no longer raises
    opt = topt.EbvPreconditioned([torch.nn.Parameter(torch.zeros(4, 4))], b2=0.95,
                                 solve_tolerance=tolerance)
    assert opt.solve_tolerance == pytest.approx({"auto": 0.005, 1e-3: 1e-3, 0.0: 0.0}[tolerance])


def test_schedules_and_clipping_match_the_reference():
    for step in (0, 1, 2, 5, 9, 10, 14):
        close(topt.warmup_cosine(1e-2, 3, 10)(step), np.asarray(jopt.warmup_cosine(1e-2, 3, 10)(step)))
    assert topt.constant_lr(0.5)(7) == 0.5
    g = tree(12)
    clipped, norm = topt.clip_by_global_norm([torch.from_numpy(x) for x in g.values()], 1.0)
    jclipped, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    close(norm, np.asarray(jnorm))
    close(topt.global_norm(torch.from_numpy(x) for x in g.values()),
          np.asarray(jopt.global_norm(jax.tree.map(jnp.asarray, g))))
    for x, k in zip(clipped, g):
        close(x, np.asarray(jclipped[k]))


def test_get_optimizer_and_the_package_exports():
    p = [torch.nn.Parameter(torch.zeros(3, 3))]
    assert isinstance(train.get_optimizer("adamw", p, 1e-3), train.AdamW)
    assert isinstance(train.get_optimizer("ebv", p, train.constant_lr(1e-3)), train.EbvPreconditioned)
    with pytest.raises(ValueError, match="unknown optimizer"):
        train.get_optimizer("sgd", p, 1e-3)


def test_parameters_without_a_gradient_are_left_alone():
    named, opt = convert.optimizer_from_numpy(tree(13, 0.1), None, port("ebv", 1e-2), device="cpu")
    grads = tree(14)
    for k in ("w1", "w2", "bias"):
        named[k].grad = torch.from_numpy(grads[k])
    frozen = {k: p.detach().clone() for k, p in named.items()}
    opt.step()
    for k, p in named.items():
        assert torch.equal(p.detach(), frozen[k]) == (k not in ("w1", "w2", "bias"))
        assert (p in opt.state) == (k in ("w1", "w2", "bias"))
