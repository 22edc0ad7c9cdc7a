"""The port's encdec family (whisper) against the reference's, on the CPU,
at ``whisper_tiny.reduced()`` (2 + 2 layers, d 64, 4 query and 2 KV heads,
Dh 16), with the reference's weights carried across
(``convert.lm_params_from_numpy`` / ``train_state_from_numpy``): the
sinusoid, the encoder block, the cross-attention sublayer, prefill and
decode (dense and paged), the loss and its gradients, train steps, the
serving engine, checkpoints and the launchers.

Tolerances, normwise ``max|port - ref| <= tol * max|ref|``, as
``tests/test_torch_lm.py`` and ``tests/test_torch_train.py`` set them:
fp32 1e-5 and bf16 4e-2 for the forward; the loss 1e-5 and every gradient
leaf 1e-4; after a train step ``mu``, ``nu``, ``cov``, the loss and gnorm
1e-5, the parameters 1e-4 and their update 1e-3; a train history 1e-4.

The frontend stub draws its frames from a seed in each package (JAX's
``PRNGKey`` there, a ``torch.Generator`` here), so where a test runs a
whole engine or trainer both sides' frames are replaced by one numpy
array: ``repro.serve.engine.Engine._model_batch`` and
``repro.train.loop.make_batch_fn`` there, ``repro_torch.models.lm.
stub_frames`` here.  The reference's paged decode reaches its Pallas
kernel, which jax releases without ``pl.load`` cannot run; those tests swap
in its pure-jnp twin, ``paged_decode_attention_ref``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.kernels import paged_attn as ref_paged
from repro.models import blocks as RB
from repro.models import common as RC
from repro.models import lm as RL
from repro.serve import engine as ref_engine
from repro.train import loop as RLOOP
from repro.train import optimizer as jopt
from repro_torch import convert, solvers
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import lm as TL
from repro_torch.serve import Engine, GenRequest
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as topt

ARCH = "whisper_tiny"
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


def frames_of(b, se, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, se, d)).astype(np.float32)


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SOLVERS_CACHE", str(tmp_path / "absent.json"))
    solvers.invalidate()
    yield
    solvers.invalidate()


@pytest.fixture(scope="module")
def models():
    """dtype → (ref cfg, port cfg, ref params, port model)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        rc = ref_config(ARCH).reduced().replace(dtype=dtype)
        tc = get_config(ARCH).reduced().replace(dtype=dtype)
        params = RL.init_params(jax.random.PRNGKey(0), rc)
        out[dtype] = (rc, tc, params, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), tc,
                                                                   device="cpu"))
    return out


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [64, 384])
def test_sinusoid(d):
    pos = np.array([0, 1, 7, 100, 447], np.int32)
    got = TL._sinusoid(t(pos), d)
    assert got.dtype == torch.float32
    close(got, RL._sinusoid(j(pos), d), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_encoder_block(models, dtype):
    rc, tc, params, model = models[dtype]
    bp = jax.tree.map(lambda a: a[1], params["enc_blocks"])
    x = np.random.default_rng(1).standard_normal((2, 11, rc.d_model)).astype(np.float32)
    want = RB.apply_encoder_block(bp, j(x, dtype), rc)
    got = TB.apply_encoder_block(model.enc_blocks[1], t(x, dtype), tc)
    assert str(got.dtype).endswith(dtype)
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_cross_attention_layer_from_enc_out_and_from_the_cache(models, dtype):
    rc, tc, params, model = models[dtype]
    lp = jax.tree.map(lambda a: a[0], params["blocks"]["cross"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, rc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 7, rc.d_model)).astype(np.float32)
    want, (wk, wv) = RC.apply_cross_attention_layer(lp, j(x, dtype), rc, enc_out=j(enc, dtype))
    got, (gk, gv) = TC.apply_cross_attention_layer(model.blocks[0].cross, t(x, dtype), tc,
                                                   enc_out=t(enc, dtype))
    close(got, want, TOL[dtype])
    close(gk, wk, TOL[dtype])
    close(gv, wv, TOL[dtype])
    # decode: one query a row over cached K/V
    kv = rng.standard_normal((2, 2, 7, rc.num_kv_heads, rc.resolved_head_dim)).astype(np.float32)
    want, _ = RC.apply_cross_attention_layer(lp, j(x[:, :1], dtype), rc,
                                             cross_kv=(j(kv[0], dtype), j(kv[1], dtype)))
    got, (ck, _) = TC.apply_cross_attention_layer(model.blocks[0].cross, t(x[:, :1], dtype), tc,
                                                  cross_kv=(t(kv[0], dtype), t(kv[1], dtype)))
    close(got, want, TOL[dtype])
    assert ck.shape == (2, 7, rc.num_kv_heads, rc.resolved_head_dim)


def test_init_caches_carry_the_cross_kv():
    rc, tc = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = RL.init_caches(rc, 3, 20, enc_len=5)
    got = TL.init_caches(tc, 3, 20, enc_len=5, device="cpu")
    assert sorted(got) == sorted(want) == ["attn", "cross_k", "cross_v"]
    for a, b in zip(convert.named_leaves(got).values(), leaves(want).values()):
        np.testing.assert_array_equal(a.numpy(), b)
    wp = RL.init_paged_caches(rc, 3, 9, 4, enc_len=5)
    gp = TL.init_paged_caches(tc, 3, 9, 4, enc_len=5, device="cpu")
    assert {k: tuple(v.shape) for k, v in convert.named_leaves(gp).items()} == \
        {k: v.shape for k, v in leaves(wp).items()}


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_four_dense_decode_steps(models, dtype):
    rc, tc, params, model = models[dtype]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, rc.vocab_size, (2, 12)).astype(np.int32)
    fr = frames_of(2, 3, rc.d_model, seed=4)
    last = np.array([11, 7], np.int32)
    wcache, wl = RL.prefill(params, {"tokens": j(toks), "frames": j(fr, dtype)}, rc, cache_len=20,
                            last=j(last))
    gcache, gl = TL.prefill(model, {"tokens": toks, "frames": t(fr, dtype)}, tc, cache_len=20, last=last)
    assert gl.dtype == torch.float32 and gl.shape == (2, 1, TL.padded_vocab_size(tc))
    close(gl, wl, TOL[dtype])
    for key in ("cross_k", "cross_v"):
        assert tuple(gcache[key].shape) == (rc.num_layers, 2, 3, rc.num_kv_heads, rc.resolved_head_dim)
        close(gcache[key], wcache[key], TOL[dtype])
    close(gcache["attn"]["k"], wcache["attn"]["k"], TOL[dtype])
    pos = last + 1
    for step in range(4):
        nxt = rng.integers(0, rc.vocab_size, (2, 1)).astype(np.int32)
        wcache, wl = RL.decode_step(params, wcache, j(nxt), j(pos), rc)
        gcache, gl = TL.decode_step(model, gcache, nxt, pos, tc)
        close(gl, wl, TOL[dtype])
        pos = pos + 1
    close(gcache["attn"]["v"], wcache["attn"]["v"], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_four_paged_decode_steps(models, dtype, monkeypatch):
    monkeypatch.setattr(ref_paged, "paged_decode_attention", ref_paged.paged_decode_attention_ref)
    rc, tc, params, model = models[dtype]
    rng = np.random.default_rng(5)
    page, s = 4, 10
    toks = rng.integers(0, rc.vocab_size, (2, s)).astype(np.int32)
    fr = frames_of(2, 2, rc.d_model, seed=6)
    last = np.array([9, 5], np.int32)
    wraw, wl = RL.prefill(params, {"tokens": j(toks), "frames": j(fr, dtype)}, rc, last=j(last),
                          raw_kv=True)
    graw, gl = TL.prefill(model, {"tokens": toks, "frames": t(fr, dtype)}, tc, last=last, raw_kv=True)
    close(gl, wl, TOL[dtype])
    assert sorted(graw) == ["attn", "cross_k", "cross_v"] and sorted(graw["attn"]) == ["k", "v"]
    # the reference's fresh K/V, in pages 1-4 (row 0) and 5-8 (row 1), a hole at row 1's page 3
    table = np.array([[1, 2, 3, 4], [5, 6, -1, 8]], np.int32)
    wcache = RL.init_paged_caches(rc, 2, 9, page, enc_len=2)
    gcache = TL.init_paged_caches(tc, 2, 9, page, enc_len=2, device="cpu")
    ref_kv = {n: np.asarray(wraw["attn"][n].astype(jnp.float32)) for n in ("k", "v")}
    for n in ("k", "v"):
        pool = np.zeros(wcache["attn"][f"{n}_pages"].shape, np.float32)
        for r in range(2):
            fresh = np.pad(ref_kv[n][:, r], ((0, 0), (0, 3 * page - s), (0, 0), (0, 0)))
            for i in range(3):
                if table[r, i] >= 0:
                    pool[:, table[r, i]] = fresh[:, i * page:(i + 1) * page]
        wcache["attn"][f"{n}_pages"] = j(pool, dtype)
        gcache["attn"][f"{n}_pages"] = t(pool, dtype)
        cross = np.asarray(wraw[f"cross_{n}"].astype(jnp.float32))
        wcache[f"cross_{n}"] = j(cross, dtype)
        gcache[f"cross_{n}"] = t(cross, dtype)
        close(graw[f"cross_{n}"], cross, TOL[dtype])
    pos = last + 1
    for step in range(4):
        nxt = rng.integers(0, rc.vocab_size, (2, 1)).astype(np.int32)
        wcache, wl = RL.decode_step(params, wcache, j(nxt), j(pos), rc, page_table=j(table))
        gcache, gl = TL.decode_step(model, gcache, nxt, pos, tc, page_table=t(table))
        close(gl, wl, TOL[dtype])
        pos = pos + 1
    close(gcache["attn"]["k_pages"], wcache["attn"]["k_pages"], TOL[dtype])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def whisper():
    rc, tc = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    params = RL.init_params(jax.random.PRNGKey(1), rc)
    return rc, tc, params, jax.tree.map(np.asarray, params)


def batch_of(b, s, d, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, s)).astype(np.int32), frames_of(b, max(s // 4, 1), d, seed + 100)


def test_train_loss_metrics_and_every_gradient_leaf_match_the_reference(whisper):
    rc, tc, params, tree = whisper
    toks, fr = batch_of(3, 40, rc.d_model, seed=7)
    fn = jax.jit(jax.value_and_grad(lambda p, b: RL.train_loss(p, b, rc), has_aux=True))
    (want, wmet), wgrad = fn(params, {"tokens": j(toks), "frames": j(fr)})
    tp = TL.train_params(convert.lm_params_from_numpy(tree, tc, device="cpu"))
    loss, met = TL.train_loss(tp, {"tokens": toks, "frames": t(fr)}, tc)
    grads = torch.autograd.grad(loss, list(tp.values()))
    close(loss, want, 1e-5)
    assert set(met) == set(wmet) == {"ce", "aux"}
    close(met["ce"], wmet["ce"], 1e-5)
    assert float(met["aux"]) == float(wmet["aux"]) == 0.0
    wg = leaves(wgrad)
    assert list(tp) == list(wg)  # the stacked layout, encoder and cross leaves in the reference's order
    for (name, p), g in zip(tp.items(), grads):
        assert g.shape == p.shape
        close(g, wg[name], 1e-4)


def test_the_optimizers_decay_and_precondition_exactly_the_references_leaves():
    # whisper-tiny at full width: embed and unembed make the order-384
    # group (m = 51968), the five stacked norm scales (4, 384) the order-4 one
    rc, tc = ref_config(ARCH), get_config(ARCH)
    ref = convert.named_leaves(jax.eval_shape(lambda k: RL.init_params(k, rc), jax.random.PRNGKey(0)))
    shapes = TL._train_shapes(tc)
    assert list(shapes) == list(ref)
    assert {k: s for k, (s, _) in shapes.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    assert {k: str(dt).removeprefix("torch.") for k, (_, dt) in shapes.items()} == \
        {k: str(v.dtype) for k, v in ref.items()}
    metas = [torch.empty(s, dtype=dt, device="meta") for s, dt in shapes.values()]
    opt = topt.EbvPreconditioned([torch.nn.Parameter(m) for m in metas])
    group = opt.param_groups[0]
    pre = {k for k, m in zip(shapes, metas) if opt.eligible(m, group)}
    assert pre == {k for k, v in ref.items() if v.ndim == 2 and min(v.shape) <= 1024}
    orders = {}
    for k in pre:
        orders.setdefault(min(shapes[k][0]), []).append(k)
    assert {n: len(ks) for n, ks in orders.items()} == {4: 5, 384: 2}
    assert sorted(orders[384]) == ["embed", "unembed"]
    decayed = {k for k, m in zip(shapes, metas) if m.ndim >= 2}
    assert decayed == {k for k, v in ref.items() if v.ndim >= 2} == \
        set(shapes) - {"ln_f.scale", "enc_ln_f.scale"}


def ref_optimizer(name):
    return jopt.get_optimizer(name, jopt.warmup_cosine(1e-2, 2, 10), max_grad_norm=1.0)


def port_optimizer(name):
    return lambda ps: topt.get_optimizer(name, ps, topt.warmup_cosine(1e-2, 2, 10), max_grad_norm=1.0)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_one_train_step_matches_the_reference_from_its_state(whisper, name, microbatches):
    rc, tc, params, _ = whisper
    jo = ref_optimizer(name)
    step = jax.jit(RLOOP.make_train_step(rc, jo, microbatches=microbatches))
    (t1, f1), (t2, f2) = batch_of(4, 33, rc.d_model, 8), batch_of(4, 33, rc.d_model, 9)
    p1, s1, _ = step(params, jo.init(params), {"tokens": j(t1), "frames": j(f1)})
    p2, s2, wmet = step(p1, s1, {"tokens": j(t2), "frames": j(f2)})
    state = {k: jax.tree.map(np.asarray, v) for k, v in s1.items()}
    named, opt = convert.train_state_from_numpy(jax.tree.map(np.asarray, p1), state, tc,
                                                port_optimizer(name), device="cpu")
    before = {k: p.detach().clone() for k, p in named.items()}
    met = TLOOP.make_train_step(tc, opt, microbatches=microbatches)(
        named, {"tokens": torch.from_numpy(t2), "frames": t(f2)})
    for key in ("loss", "gnorm", "ce"):
        close(met[key], wmet[key], 1e-5)
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


def test_the_ebv_step_solves_the_references_order_groups(whisper):
    rc, tc, params, tree = whisper
    named, opt = convert.train_state_from_numpy(tree, None, tc, port_optimizer("ebv"), device="cpu")
    toks, fr = batch_of(2, 16, rc.d_model, 10)
    with solvers.record_dispatches() as log:
        TLOOP.make_train_step(tc, opt)(named, {"tokens": torch.from_numpy(toks), "frames": t(fr)})
    # order 2 (five stacked norm scales, L = 2), then order 64 (embed, unembed)
    assert [(pr.op, pr.n, pr.batch) for pr, _ in log] == [
        ("factor", 2, 5), ("solve", 2, 5), ("factor", 64, 2), ("solve", 64, 2)]


def test_make_batch_fn_gives_the_stub_frames():
    cfg = get_config(ARCH).reduced()
    tc = TLOOP.TrainConfig(seed=3)
    toks = np.random.default_rng(0).integers(0, 256, (4, 18)).astype(np.int32)
    batch = TLOOP.make_batch_fn(cfg, tc, device="cpu")(toks)
    want = RLOOP.make_batch_fn(ref_config(ARCH).reduced(), RLOOP.TrainConfig(seed=3))(toks)
    assert sorted(batch) == sorted(want) == ["frames", "tokens"]
    assert tuple(batch["frames"].shape) == want["frames"].shape == (4, 4, cfg.d_model)
    assert str(batch["frames"].dtype).endswith(str(want["frames"].dtype))
    np.testing.assert_array_equal(batch["tokens"].numpy(), toks)
    assert torch.equal(batch["frames"], TL.stub_frames(4, 4, cfg, 3, device="cpu"))
    assert not torch.equal(batch["frames"], TL.stub_frames(4, 4, cfg, 4, device="cpu"))


def shared_frames(monkeypatch, d, *, train_seed=None):
    """Both packages' frontend stubs replaced by one numpy array."""
    table = frames_of(64, 64, d, seed=11)

    def port(batch, enc_len, cfg, seed=0, *, device=None):
        return t(table[:batch, :enc_len]).to(device)

    monkeypatch.setattr(TL, "stub_frames", port)
    if train_seed is None:
        def ref_batch(self, tokens):
            b, s = tokens.shape
            return {"tokens": jnp.asarray(tokens), "frames": j(table[:b, :max(s // 4, 1)])}

        monkeypatch.setattr(ref_engine.Engine, "_model_batch", ref_batch)
    else:
        def ref_batch_fn(model_cfg, train_cfg):
            return lambda toks: {"tokens": jnp.asarray(toks),
                                 "frames": j(table[:toks.shape[0], :max(toks.shape[1] // 4, 1)])}

        monkeypatch.setattr(RLOOP, "make_batch_fn", ref_batch_fn)


@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_four_steps_of_train_match_the_reference(whisper, name, monkeypatch):
    rc, tc, params, tree = whisper
    shared_frames(monkeypatch, rc.d_model, train_seed=0)
    kw = dict(steps=4, seq_len=24, global_batch=4, warmup_steps=2, optimizer=name, learning_rate=1e-2)
    _, want = RLOOP.train(rc, RLOOP.TrainConfig(**kw), params=jax.tree.map(jnp.copy, params))
    _, got = TLOOP.train(tc, TLOOP.TrainConfig(**kw), device="cpu",
                         params=TL.train_params(convert.lm_params_from_numpy(tree, tc, device="cpu")))
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2, 3]
    close([h["loss"] for h in got], [h["loss"] for h in want], 1e-4)
    close([h["gnorm"] for h in got], [h["gnorm"] for h in want], 1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def ragged(kind, vocab):
    """tests/test_paged.py's ragged requests of the families test."""
    rng = np.random.default_rng(0)
    return [kind(tokens=rng.integers(0, vocab, (s,)).astype(np.int32), max_new_tokens=n, seed=i)
            for i, (s, n) in enumerate([(5, 4), (8, 2), (3, 6)])]


def stats_of(st):
    return (st.prefill_dispatches, st.decode_dispatches, st.generated_tokens, st.padding_frac,
            st.peak_active, st.events)


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_serve_equals_the_reference_engine(models, paged, monkeypatch):
    monkeypatch.setattr(ref_paged, "paged_decode_attention", ref_paged.paged_decode_attention_ref)
    rc, tc, params, model = models["float32"]
    shared_frames(monkeypatch, rc.d_model)
    kw = dict(max_len=64, slots=2, bucket=4, **(dict(paged=True, page_size=16) if paged else {}))
    ref = ref_engine.Engine(params, rc, **kw)
    want = ref.serve(ragged(ref_engine.GenRequest, rc.vocab_size))
    eng = Engine(model, tc, **kw)
    got = eng.serve(ragged(GenRequest, tc.vocab_size))
    assert len(got) == len(want) == 3
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"request {i}")
    assert stats_of(eng.stats) == stats_of(ref.stats)
    if paged:
        assert eng.prefix_cache is None and ref.prefix_cache is None  # prefix reuse: dense family only
        assert eng.stats.pool_peak_pages == ref.stats.pool_peak_pages
    # a second call over the persistent pool, with fewer slots: fresh cross caches
    again = eng.serve(ragged(GenRequest, tc.vocab_size)[:2], slots=1)
    for a, b in zip(again, got[:2]):
        np.testing.assert_array_equal(a, b)


def test_paged_serve_is_bitwise_the_dense_serve_and_pads_one_bucket(models):
    _, tc, _, model = models["bfloat16"]
    reqs = ragged(GenRequest, tc.vocab_size)
    dense = Engine(model, tc, max_len=64, slots=2, bucket=4)
    paged = Engine(model, tc, max_len=64, slots=2, bucket=4, paged=True, page_size=16)
    for a, b in zip(dense.serve(reqs), paged.serve(reqs)):
        np.testing.assert_array_equal(a, b)
    # every prompt padded to the largest request's bucket (8): 8 - 5, 8 - 8, 8 - 3 pad tokens
    assert dense.stats.padding_frac == paged.stats.padding_frac == pytest.approx(8 / 24)


# ---------------------------------------------------------------------------
# checkpoints and the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_a_whisper_train_state_round_trips_bit_for_bit(tmp_path, name):
    cfg = get_config(ARCH).reduced().replace(dtype="bfloat16")
    params = TL.train_params(TL.init_params(5, cfg, device="cpu"))
    opt = topt.get_optimizer(name, list(params.values()), 1e-3)
    toks = np.random.default_rng(12).integers(0, 256, (2, 16)).astype(np.int32)
    TLOOP.make_train_step(cfg, opt)(params, TLOOP.make_batch_fn(cfg, TLOOP.TrainConfig(),
                                                                device="cpu")(toks))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, TLOOP.state_tree(params, opt))
    fresh = TL.train_params(TL.init_params(6, cfg, device="cpu"))
    fopt = topt.get_optimizer(name, list(fresh.values()), 1e-3)
    tree, _, step = mgr.restore(TLOOP._template(fresh, fopt))
    TLOOP.load_state_tree(fresh, fopt, tree)
    assert step == 1 and list(fresh) == list(params)
    assert any(k.startswith("enc_blocks.") for k in fresh) and "blocks.cross.wq" in fresh
    for k, p in params.items():
        q = fresh[k]
        assert q.dtype == p.dtype and torch.equal(q.view(torch.int16) if q.dtype == torch.bfloat16 else q,
                                                  p.view(torch.int16) if p.dtype == torch.bfloat16 else p), k
        for key in ("mu", "nu") + (("cov",) if name == "ebv" else ()):
            assert torch.equal(fopt.state[q][key], opt.state[p][key]), (k, key)
        assert fopt.state[q]["step"] == opt.state[p]["step"] == 1


@pytest.mark.parametrize("optimizer", ["adamw", "ebv"])
def test_the_training_launcher_trains_whisper_on_the_cpu(optimizer, capsys):
    launch_train.main(["--arch", ARCH, "--reduced", "--steps", "3", "--device", "cpu",
                       "--optimizer", optimizer, "--seq-len", "32", "--batch", "4"])
    assert "[train] step     0 loss" in capsys.readouterr().out


@pytest.mark.parametrize("paged", [False, True])
def test_the_serving_launcher_serves_whisper_on_the_cpu(paged, capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "3", "--ragged",
                       "--slots", "2"] + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert ("prefix reuse: 0 warm admissions" in out) == paged
