"""The port's ssm family (mamba2) and hybrid family (hymba) against the
reference's, on the CPU, at ``.reduced()`` (2 layers, d 64, d_inner 128,
8 SSM heads of 16, state 16, chunk 16, conv 4; hymba's attention 4 query
and 2 KV heads of Dh 16 in a window of 32), with the reference's weights
carried across (``convert.lm_params_from_numpy`` /
``train_state_from_numpy``): the Mamba-2 mixer (``ssd_chunked`` and the
layer in train, prefill and decode mode), pad-invariant prefill, prefill
and decode through the model, the serving engine, the loss and its
gradients, train steps, checkpoints and the launchers, and the one
departure from the reference: the port's gradients stay finite where the
reference's masked ``exp`` overflows (``models/mamba2.py``).

Tolerances, normwise ``max|port - ref| <= tol * max|ref|``, as
``tests/test_torch_moe.py`` sets them: fp32 1e-5 and bf16 4e-2 for the
forward and the caches; the loss 1e-5 and every gradient leaf 1e-4; after
a train step ``mu``, ``nu``, ``cov``, the loss and gnorm 1e-5, the
parameters 1e-4 and their update 1e-3, both on every entry whose gradient
RMS is not round-off sized (above 0 and under 1e-5 of its leaf's largest,
at most 1 % of a leaf): Adam moves such an entry by the sign of its
round-off.  A padded prefill is held to its
exact-length prefill within 1e-5 in fp32: the reference's is not bitwise
either, because its chunk length, and with it the products' shapes,
follows the padded length.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import lm as RL
from repro.models import mamba2 as RM
from repro.serve import engine as ref_engine
from repro.train import loop as RLOOP
from repro.train import optimizer as jopt
from repro_torch import convert, solvers
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as TL
from repro_torch.models import mamba2 as TM
from repro_torch.serve import Engine, GenRequest
from repro_torch.serve.engine import _insert_slot
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as topt

ARCHS = ("mamba2_1_3b", "hymba_1_5b")
TOL = {"float32": 1e-5, "bfloat16": 4e-2}


def close(got, want, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want).astype(np.float32), np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"normwise {err:.3e} > {tol:.0e}"


def t(x, dtype=None):
    out = convert.tensor_from_numpy(np.asarray(x), device="cpu")
    return out if dtype is None else out.to(getattr(torch, dtype))


def j(x, dtype=None):
    return jnp.asarray(x) if dtype is None else jnp.asarray(x, jnp.dtype(dtype))


def leaves(tree):
    return convert.named_leaves(jax.tree.map(np.asarray, tree))


def cfgs(arch, dtype="float32", **kw):
    return (ref_config(arch).reduced().replace(dtype=dtype, **kw),
            get_config(arch).reduced().replace(dtype=dtype, **kw))


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    yield
    solvers.invalidate()


@pytest.fixture(scope="module")
def models():
    """(arch, dtype) → (ref cfg, port cfg, ref params, port model)."""
    out = {}
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            rc, tc = cfgs(arch, dtype)
            params = RL.init_params(jax.random.PRNGKey(0), rc)
            out[arch, dtype] = (rc, tc, params, convert.lm_params_from_numpy(
                jax.tree.map(np.asarray, params), tc, device="cpu"))
    return out


# ---------------------------------------------------------------------------
# the Mamba-2 mixer
# ---------------------------------------------------------------------------
def ssm_layer(dtype, seed=0):
    """A layer's reference params and the port's SSM module holding them."""
    rc, tc = cfgs("mamba2_1_3b", dtype)
    p = {k: v[0] for k, v in RM.init_ssm(jax.random.PRNGKey(seed), rc).items()}  # (array, axes) → array
    mod = TM.init_ssm(torch.Generator().manual_seed(0), tc)
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(t(np.asarray(v)))
    return rc, tc, p, mod


def ssd_inputs(s, seed):
    """x (2, s, 8, 16), dt in (1e-3, 1e-1), a = dt·(−(1..8)), B and C (2, s, 16)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, 8, 16)).astype(np.float32)
    dt = rng.uniform(1e-3, 1e-1, (2, s, 8)).astype(np.float32)
    a = (dt * -np.arange(1, 9, dtype=np.float32)).astype(np.float32)
    bm = rng.standard_normal((2, s, 16)).astype(np.float32)
    cm = rng.standard_normal((2, s, 16)).astype(np.float32)
    return x, dt, a, bm, cm


# 40 steps in chunks of 16: a padded tail; 10 < 16: one chunk of the
# sequence's length; 48: three full chunks
@pytest.mark.parametrize("s", [40, 10, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_the_reference(s, dtype):
    x, dt, a, bm, cm = ssd_inputs(s, 1)
    want, wstate = RM.ssd_chunked(j(x, dtype), j(dt, dtype), j(a), j(bm, dtype), j(cm, dtype), chunk=16)
    got, gstate = TM.ssd_chunked(t(x, dtype), t(dt, dtype), t(a), t(bm, dtype), t(cm, dtype), chunk=16)
    assert got.dtype == getattr(torch, dtype) and gstate.dtype == torch.float32
    close(got, want, TOL[dtype])
    close(gstate, wstate, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_ssm_layer_in_train_prefill_and_decode_mode(dtype):
    rc, tc, p, mod = ssm_layer(dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 21, rc.d_model)).astype(np.float32)
    lengths = np.array([21, 2, 13], np.int32)  # one row shorter than the conv's window
    want, _ = RM.apply_ssm_layer(p, j(x, dtype), rc, mode="train")
    got, none = TM.apply_ssm_layer(mod, t(x, dtype), tc, mode="train")
    assert none is None
    close(got, want, TOL[dtype])
    for ln in (None, lengths):
        want, wc = RM.apply_ssm_layer(p, j(x, dtype), rc, mode="prefill",
                                      lengths=None if ln is None else j(ln))
        got, gc = TM.apply_ssm_layer(mod, t(x, dtype), tc, mode="prefill", lengths=ln)
        close(got, want, TOL[dtype])
        assert sorted(gc) == sorted(wc) == ["conv_b", "conv_c", "conv_x", "state"]
        for k in wc:
            assert gc[k].dtype == (torch.float32 if k == "state" else getattr(torch, dtype))
            close(gc[k], wc[k], TOL[dtype])
    for step in range(4):
        xs = rng.standard_normal((3, 1, rc.d_model)).astype(np.float32)
        want, wc = RM.apply_ssm_layer(p, j(xs, dtype), rc, mode="decode", cache=wc)
        got, gc = TM.apply_ssm_layer(mod, t(xs, dtype), tc, mode="decode", cache=gc)
        close(got, want, TOL[dtype])
    for k in wc:
        close(gc[k], wc[k], TOL[dtype])


def test_the_ssm_init_layout_and_laws():
    rc, tc = cfgs("mamba2_1_3b", "bfloat16")
    want = {k: (v[0].shape, str(v[0].dtype)) for k, v in RM.init_ssm(jax.random.PRNGKey(0), rc).items()}
    mod = TM.init_ssm(torch.Generator().manual_seed(0), tc)
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in mod.named_parameters()}
    assert got == want
    h = tc.ssm_heads
    assert torch.equal(mod.a_log, torch.log(torch.arange(1, h + 1, dtype=torch.float32)))
    assert bool((mod.d_skip == 1).all()) and bool((mod.norm_scale == 1).all())
    dt0 = torch.nn.functional.softplus(mod.dt_bias)
    assert bool(((dt0 > 0.999e-3) & (dt0 < 1.001e-1)).all())
    cache = TM.init_ssm_cache(tc, 3, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "conv_x": (3, 3, tc.d_inner), "conv_b": (3, 3, 16), "conv_c": (3, 3, 16), "state": (3, h, 16, 16)}
    assert cache["state"].dtype == torch.float32 and cache["conv_x"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf_of_both_families(models, arch):
    _, tc, params, model = models[arch, "bfloat16"]
    tree = leaves(params)
    names = {n for n, _ in model.named_parameters()}
    assert len(names) == sum(np.asarray(v).shape[0] if k.startswith("blocks.") else 1 for k, v in tree.items())
    assert {"blocks.1.ssm.a_log", "blocks.0.ssm.conv_x"} <= names
    assert ("blocks.0.beta_attn" in names) == (arch == "hymba_1_5b")
    for name, p in model.named_parameters():
        parts = name.split(".")
        want = tree[".".join(parts[:1] + parts[2:])][int(parts[1])] if parts[0] == "blocks" else tree[name]
        assert torch.equal(p.float(), t(np.asarray(want).astype(np.float32)))


# ---------------------------------------------------------------------------
# prefill and decode through the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_the_reference(models, arch, dtype):
    rc, tc, params, model = models[arch, dtype]
    rng = np.random.default_rng(10)
    toks = rng.integers(0, rc.vocab_size, (2, 40)).astype(np.int32)
    last = np.array([39, 25], np.int32)  # row 1 right-padded past its 26 tokens
    wcache, wl = RL.prefill(params, {"tokens": j(toks)}, rc, cache_len=80, last=j(last))
    gcache, gl = TL.prefill(model, {"tokens": toks}, tc, cache_len=80, last=last)
    close(gl, wl, TOL[dtype])
    assert sorted(gcache) == sorted(wcache) == (["attn", "ssm"] if arch == "hymba_1_5b" else ["ssm"])
    for k in wcache["ssm"]:
        close(gcache["ssm"][k], wcache["ssm"][k], TOL[dtype])
    pos = last + 1
    for step in range(6):  # row 0 passes position 44, past hymba's window of 32
        nxt = rng.integers(0, rc.vocab_size, (2, 1)).astype(np.int32)
        wcache, wl = RL.decode_step(params, wcache, j(nxt), j(pos), rc)
        gcache, gl = TL.decode_step(model, gcache, nxt, pos, tc)
        close(gl, wl, TOL[dtype])
        pos = pos + 1
    for k in wcache["ssm"]:
        close(gcache["ssm"][k], wcache["ssm"][k], TOL[dtype])


@pytest.mark.parametrize("arch,layers", [("mamba2_1_3b", 48), ("hymba_1_5b", 32)])
def test_bf16_rounding_through_the_full_depth_is_of_the_references_order(arch, layers):
    """At the full model's depth (``.reduced()``'s width), the bf16 forward's
    distance from the fp32 forward, the port's against the reference's:
    rounding carried through 48 / 32 layers, the floor that the served
    bf16 decode is held to on the card (measured here: reference 6.4e-2 /
    5.0e-2, port 9.3e-2 / 6.8e-2)."""
    toks = np.random.default_rng(12).integers(0, 256, (2, 64)).astype(np.int32)
    logits = {}
    for dtype in ("float32", "bfloat16"):
        rc, tc = cfgs(arch, dtype, num_layers=layers)
        params = RL.init_params(jax.random.PRNGKey(0), rc)
        model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
        _, wl = RL.prefill(params, {"tokens": j(toks)}, rc)
        _, gl = TL.prefill(model, {"tokens": toks}, tc)
        logits[dtype] = (np.asarray(wl.astype(jnp.float32), np.float64), gl.float().numpy().astype(np.float64))
    close(logits["float32"][1], logits["float32"][0], TOL["float32"])
    drift = [np.abs(logits["bfloat16"][i] - logits["float32"][i]).max() / np.abs(logits["float32"][i]).max()
             for i in (0, 1)]
    assert 0 < drift[1] <= 2 * drift[0], f"bf16 from fp32: port {drift[1]:.3e}, reference {drift[0]:.3e}"


# 50 → 64, 2 → 8 (shorter than the conv's window of 4) and 13 → 16
@pytest.mark.parametrize("s0,lb", [(50, 64), (2, 8), (13, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_padded_prefill_equals_the_exact_length_one(models, arch, s0, lb):
    _, tc, _, model = models[arch, "float32"]
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tc.vocab_size, (1, s0)).astype(np.int32)
    padded = np.zeros((1, lb), np.int32)
    padded[0, :s0] = toks[0]
    padded[0, s0:] = rng.integers(0, tc.vocab_size, lb - s0)  # pads of any value
    want_cache, want = TL.prefill(model, {"tokens": toks}, tc)
    got_cache, got = TL.prefill(model, {"tokens": padded}, tc, last=[s0 - 1])
    close(got, want.numpy(), 1e-5)
    for k, w in want_cache["ssm"].items():
        close(got_cache["ssm"][k], w.numpy(), 1e-5)
    # without the lengths the pads would run through the recurrence
    _, blind = TL.prefill(model, {"tokens": padded}, tc)
    assert not torch.allclose(blind, want)


def test_ssm_caches_cannot_be_paged():
    _, tc = cfgs("mamba2_1_3b")
    with pytest.raises(ValueError, match="no attention KV cache"):
        TL.init_paged_caches(tc, 2, 9, 4, device="cpu")
    _, hc = cfgs("hymba_1_5b")
    with pytest.raises(ValueError, match="sliding-window"):
        TL.init_paged_caches(hc, 2, 9, 4, device="cpu")


def test_a_full_width_mamba2_builds_no_rope_tables():
    cfg = get_config("mamba2_1_3b")
    assert cfg.num_heads == 0  # resolved_head_dim would divide by zero
    small = cfg.replace(num_layers=1, d_model=64, ssm_head_dim=16, ssm_state=8, vocab_size=256)
    model = TL.init_params(0, small, device="cpu")
    cache, logits = TL.prefill(model, {"tokens": np.arange(5, dtype=np.int32)[None]}, small)
    assert logits.shape == (1, 1, 256) and bool(torch.isfinite(logits).all())
    shapes = TL._train_shapes(cfg)
    assert "blocks.attn.wq" not in shapes and shapes["blocks.ssm.x_proj"][0] == (48, 2048, 4096)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_families_serve_ragged_solo_identical(arch):
    # the port of the reference's tests/test_serve.py test of that name
    cfg = get_config(arch).reduced()
    model = TL.init_params(0, cfg, device="cpu")
    eng = Engine(model, cfg, max_len=64, slots=2, bucket=4)
    rng = np.random.default_rng(0)
    reqs = [GenRequest(tokens=rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32), max_new_tokens=n, seed=i)
            for i, (s, n) in enumerate([(5, 4), (8, 2), (3, 6)])]
    outs = eng.serve(reqs)
    for r, o in zip(reqs, outs):
        assert o.shape == (len(r.tokens) + r.max_new_tokens,)
    np.testing.assert_array_equal(outs[0], eng.serve([reqs[0]])[0])


def requests(kind, vocab, shapes):
    rng = np.random.default_rng(17)
    return [kind(tokens=rng.integers(0, vocab, (s,)).astype(np.int32), max_new_tokens=n, seed=i)
            for i, (s, n) in enumerate(shapes)]


def stats_of(st):
    return (st.prefill_dispatches, st.decode_dispatches, st.generated_tokens, st.padding_frac,
            st.peak_active, st.events)


# mamba2: prompts in buckets of 4, most with pads; hymba: prompts of 30
# (bucket 32, inside the window of 32), 37 and 45 (buckets past it: their
# exact length) and 12, each decoding past position 32
SERVED = {"mamba2_1_3b": ([(5, 4), (8, 2), (3, 6), (11, 5), (2, 7)], dict(max_len=64, slots=2, bucket=4)),
          "hymba_1_5b": ([(30, 6), (37, 9), (12, 25), (45, 4)], dict(max_len=96, slots=2, bucket=8))}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serve_equals_the_reference_engine(models, arch):
    rc, tc, params, model = models[arch, "float32"]
    shapes, kw = SERVED[arch]
    ref = ref_engine.Engine(params, rc, **kw)
    want = ref.serve(requests(ref_engine.GenRequest, rc.vocab_size, shapes))
    eng = Engine(model, tc, **kw)
    got = eng.serve(requests(GenRequest, tc.vocab_size, shapes))
    assert len(got) == len(want) == len(shapes)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"request {i}")
    assert stats_of(eng.stats) == stats_of(ref.stats)
    for s0, _ in shapes:
        assert eng._bucket_len(s0, None) == ref._bucket_len(s0, None)
    if arch == "hymba_1_5b":
        assert [eng._bucket_len(s, None) for s in (30, 37, 45)] == [32, 37, 45]


def test_the_engine_copies_a_prefill_s_ssm_leaves_into_its_slot(models):
    _, tc, _, model = models["hymba_1_5b", "float32"]
    rng = np.random.default_rng(18)
    toks = rng.integers(0, tc.vocab_size, (1, 37)).astype(np.int32)
    new, _ = TL.prefill(model, {"tokens": toks}, tc, cache_len=64, last=[36])
    live = TL.init_caches(tc, 3, 64, device="cpu")
    _insert_slot(live, new, 2, 37)
    for k, v in new["ssm"].items():
        assert torch.equal(live["ssm"][k][:, 2], v[:, 0])
        assert not live["ssm"][k][:, :2].any()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trainees():
    """arch → (ref cfg, port cfg, ref params, their numpy tree), fp32."""
    out = {}
    for arch in ARCHS:
        rc, tc = cfgs(arch)
        params = RL.init_params(jax.random.PRNGKey(1), rc)
        out[arch] = (rc, tc, params, jax.tree.map(np.asarray, params))
    return out


def tokens_of(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_metrics_and_every_gradient_leaf_match_the_reference(trainees, arch):
    rc, tc, params, tree = trainees[arch]
    toks = tokens_of(3, 40, 12)
    fn = jax.jit(jax.value_and_grad(lambda p, b: RL.train_loss(p, b, rc), has_aux=True))
    (want, wmet), wgrad = fn(params, {"tokens": j(toks)})
    tp = TL.train_params(convert.lm_params_from_numpy(tree, tc, device="cpu"))
    loss, met = TL.train_loss(tp, {"tokens": toks}, tc)
    grads = torch.autograd.grad(loss, list(tp.values()))
    close(loss, want, 1e-5)
    close(met["ce"], wmet["ce"], 1e-5)
    assert float(met["aux"]) == float(wmet["aux"]) == 0.0
    wg = leaves(wgrad)
    assert list(tp) == list(wg)
    assert {"blocks.ssm.a_log", "blocks.ssm.conv_x", "blocks.ssm.dt_bias"} <= set(tp)
    for (name, p), g in zip(tp.items(), grads):
        assert g.shape == p.shape and bool(torch.isfinite(g).all())
        close(g, wg[name], 1e-4)


@pytest.mark.parametrize("arch,groups", [("mamba2_1_3b", {48: 5}), ("hymba_1_5b", {32: 8})])
def test_the_optimizers_decay_and_precondition_exactly_the_references_leaves(arch, groups):
    # at full width: mamba2's embed (50304, 2048) and hymba's (32128, 1600)
    # pass the order cap; the stacked (L, d) and (L, H) leaves make one group
    rc, tc = ref_config(arch), get_config(arch)
    ref = convert.named_leaves(jax.eval_shape(lambda k: RL.init_params(k, rc), jax.random.PRNGKey(0)))
    shapes = TL._train_shapes(tc)
    assert list(shapes) == list(ref)
    assert {k: s for k, (s, _) in shapes.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    assert {k: str(dt).removeprefix("torch.") for k, (_, dt) in shapes.items()} == \
        {k: str(v.dtype) for k, v in ref.items()}
    metas = [torch.empty(s, dtype=dt, device="meta") for s, dt in shapes.values()]
    opt = topt.EbvPreconditioned([torch.nn.Parameter(m) for m in metas])
    pre = {k for k, m in zip(shapes, metas) if opt.eligible(m, opt.param_groups[0])}
    assert pre == {k for k, v in ref.items() if v.ndim == 2 and min(v.shape) <= 1024}
    orders = {}
    for k in pre:
        orders[min(shapes[k][0])] = orders.get(min(shapes[k][0]), 0) + 1
    assert orders == groups
    widest = max(max(shapes[k][0]) for k in pre)
    assert widest == tc.d_inner  # the stacked norm_scale (L, d_inner)
    decayed = {k for k, m in zip(shapes, metas) if m.ndim >= 2}
    assert decayed == {k for k, v in ref.items() if v.ndim >= 2} >= {"blocks.ssm.a_log", "blocks.ssm.conv_x"}


def ref_optimizer(name):
    return jopt.get_optimizer(name, jopt.warmup_cosine(1e-2, 2, 10), max_grad_norm=1.0)


def port_optimizer(name):
    return lambda ps: topt.get_optimizer(name, ps, topt.warmup_cosine(1e-2, 2, 10), max_grad_norm=1.0)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_one_train_step_matches_the_reference_from_its_state(trainees, arch, name, microbatches):
    rc, tc, params, _ = trainees[arch]
    jo = ref_optimizer(name)
    step = jax.jit(RLOOP.make_train_step(rc, jo, microbatches=microbatches))
    t1, t2 = tokens_of(4, 40, 13), tokens_of(4, 40, 14)  # past hymba's window of 32
    p1, s1, _ = step(params, jo.init(params), {"tokens": j(t1)})
    p2, s2, wmet = step(p1, s1, {"tokens": j(t2)})
    state = {k: jax.tree.map(np.asarray, v) for k, v in s1.items()}
    named, opt = convert.train_state_from_numpy(jax.tree.map(np.asarray, p1), state, tc,
                                                port_optimizer(name), device="cpu")
    before = {k: p.detach().clone() for k, p in named.items()}
    met = TLOOP.make_train_step(tc, opt, microbatches=microbatches)(named, {"tokens": torch.from_numpy(t2)})
    for key in ("loss", "gnorm", "ce"):
        close(met[key], wmet[key], 1e-5)
    want, mu, nu = leaves(p2), leaves(s2["mu"]), leaves(s2["nu"])
    for k, p in named.items():
        st = opt.state[p]
        assert st["step"] == 2 == int(s2["step"])
        # Adam moves an entry by ~lr·sign(m) however small m is, so an entry
        # whose gradient RMS is round-off sized (under 1e-5 of its leaf's
        # largest) moves by the sign of the round-off; its moments are held
        # below (mu, nu), its value here only where the gradient is not
        rms = np.sqrt(nu[k])
        settled = ~((rms > 0) & (rms < 1e-5 * rms.max()))
        assert settled.mean() >= 0.99, k
        scale = np.abs(want[k]).max()
        assert np.abs(p.detach().numpy() - want[k])[settled].max() <= 1e-4 * scale, k
        update, want_update = p.detach() - before[k], want[k] - leaves(p1)[k]
        assert np.abs(update.numpy() - want_update)[settled].max() <= 1e-3 * np.abs(want_update).max(), k
        close(st["mu"], mu[k], 1e-5)
        close(st["nu"], nu[k], 1e-5)
        if name == "ebv":
            cov = leaves(s2["cov"])[k]
            assert tuple(st["cov"].shape) == cov.shape
            if cov.size:
                close(st["cov"], cov, 1e-5)


@pytest.mark.parametrize("arch,systems", [("mamba2_1_3b", 5), ("hymba_1_5b", 8)])
def test_the_ebv_step_solves_the_references_order_groups(trainees, arch, systems):
    rc, tc, params, tree = trainees[arch]
    named, opt = convert.train_state_from_numpy(tree, None, tc, port_optimizer("ebv"), device="cpu")
    with solvers.record_dispatches() as log:
        TLOOP.make_train_step(tc, opt)(named, {"tokens": torch.from_numpy(tokens_of(2, 16, 15))})
    # order 2 (the stacked (2, ·) leaves: norm scales, gates, a_log, d_skip,
    # dt_bias), then order 64 (embed, unembed)
    assert [(pr.op, pr.n, pr.batch) for pr, _ in log] == [
        ("factor", 2, systems), ("solve", 2, systems), ("factor", 64, 2), ("solve", 64, 2)]


@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_four_steps_of_train_match_the_reference(trainees, name):
    rc, tc, params, tree = trainees["mamba2_1_3b"]
    kw = dict(steps=4, seq_len=24, global_batch=4, warmup_steps=2, optimizer=name, learning_rate=1e-2)
    _, want = RLOOP.train(rc, RLOOP.TrainConfig(**kw), params=jax.tree.map(jnp.copy, params))
    _, got = TLOOP.train(tc, TLOOP.TrainConfig(**kw), device="cpu",
                         params=TL.train_params(convert.lm_params_from_numpy(tree, tc, device="cpu")))
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2, 3]
    close([h["loss"] for h in got], [h["loss"] for h in want], 1e-4)


# ---------------------------------------------------------------------------
# the reference's NaN gradients from its masked exp, which the port does not copy
# ---------------------------------------------------------------------------
REF_LINE = "lmat = jnp.where(tri[None, None, :, :, None], jnp.exp(ldecay), 0.0)"
FIXED_LINE = "lmat = jnp.exp(jnp.where(tri[None, None, :, :, None], ldecay, -jnp.inf))"


def fixed_ssd_chunked():
    """The reference's ``ssd_chunked`` with that one line written as the
    port writes it, built from the reference's own source."""
    src = inspect.getsource(RM.ssd_chunked)
    assert src.count(REF_LINE) == 1, "the reference's masked exp was not found"
    ns = dict(vars(RM))
    exec(compile(src.replace(REF_LINE, FIXED_LINE), RM.__file__, "exec"), ns)
    return ns["ssd_chunked"]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_ports_gradients_are_finite_where_the_references_overflow(models, arch, monkeypatch):
    # chunks of 128 at the reduced width: where a head's dt nears its 0.1
    # bound (PRNGKey(0)'s weights: softplus(dt_bias) up to 0.092), the decay
    # above the diagonal passes exp's fp32 range (88) inside a 128-token chunk
    rc, tc = cfgs(arch, ssm_chunk=128)
    params = models[arch, "float32"][2]
    tree = jax.tree.map(np.asarray, params)
    batch = tokens_of(1, 128, 19)
    grad_fn = lambda: jax.value_and_grad(lambda p: RL.train_loss(p, {"tokens": j(batch)}, rc)[0])(params)
    ref_loss, ref_grad = grad_fn()
    ref_grad = leaves(ref_grad)
    monkeypatch.setattr(RM, "ssd_chunked", fixed_ssd_chunked())
    fix_loss, fix_grad = grad_fn()
    fix_grad = leaves(fix_grad)
    tp = TL.train_params(convert.lm_params_from_numpy(tree, tc, device="cpu"))
    loss, _ = TL.train_loss(tp, {"tokens": batch}, tc)
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    bad = sum(int((~np.isfinite(g)).sum()) for g in ref_grad.values())
    assert bad > 1000, f"the reference's gradients hold only {bad} non-finite entries"
    assert float(fix_loss) == float(ref_loss)
    close(loss, ref_loss, 1e-5)
    for k, want in ref_grad.items():
        g, fixed = grads[k], fix_grad[k]
        finite = np.isfinite(want)
        assert bool(torch.isfinite(g).all()) and np.isfinite(fixed).all(), k
        np.testing.assert_array_equal(fixed[finite], want[finite], err_msg=k)  # one line apart
        close(g, fixed, 1e-4)
        if finite.any():
            close(g.numpy()[finite], want[finite], 1e-4)


# ---------------------------------------------------------------------------
# checkpoints and the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_an_ssm_train_state_round_trips_bit_for_bit(tmp_path, name):
    cfg = get_config("hymba_1_5b").reduced().replace(dtype="bfloat16")
    params = TL.train_params(TL.init_params(5, cfg, device="cpu"))
    opt = topt.get_optimizer(name, list(params.values()), 1e-3)
    TLOOP.make_train_step(cfg, opt)(params, {"tokens": torch.from_numpy(tokens_of(2, 16, 18))})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, TLOOP.state_tree(params, opt))
    fresh = TL.train_params(TL.init_params(6, cfg, device="cpu"))
    fopt = topt.get_optimizer(name, list(fresh.values()), 1e-3)
    tree, _, step = mgr.restore(TLOOP._template(fresh, fopt))
    TLOOP.load_state_tree(fresh, fopt, tree)
    assert step == 1 and list(fresh) == list(params)
    assert fresh["blocks.beta_ssm"].dtype == torch.float32 and fresh["blocks.ssm.conv_x"].dtype == torch.bfloat16
    bits = lambda x: x.view(torch.int16) if x.dtype == torch.bfloat16 else x
    for k, p in params.items():
        q = fresh[k]
        assert q.dtype == p.dtype and torch.equal(bits(q), bits(p)), k
        for key in ("mu", "nu") + (("cov",) if name == "ebv" else ()):
            assert torch.equal(fopt.state[q][key], opt.state[p][key]), (k, key)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("optimizer", ["adamw", "ebv"])
def test_the_training_launcher_trains_both_families_on_the_cpu(arch, optimizer, capsys):
    launch_train.main(["--arch", arch, "--reduced", "--steps", "3", "--device", "cpu",
                       "--optimizer", optimizer, "--seq-len", "40", "--batch", "4"])
    assert "[train] step     0 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_the_serving_launcher_serves_both_families_on_the_cpu(arch, capsys):
    launch_serve.main(["--device", "cpu", "--arch", arch, "--reduced", "--batch", "3", "--ragged",
                       "--slots", "2", "--prompt-len", "40"])
    assert "served 3 requests" in capsys.readouterr().out
