"""The port's moe family (mixtral, granite) against the reference's, on the
CPU, at ``.reduced()`` (2 layers, d 64, 4 query and 2 KV heads, Dh 16,
4 experts of d_ff 128, top-2; mixtral's window 32) and at granite's
routing at that width (``.replace(num_experts=32, experts_per_token=8)``),
with the reference's weights carried across
(``convert.lm_params_from_numpy`` / ``train_state_from_numpy``): the MoE
layer (routing, drops, ties, the grouped path and its padded tail),
sliding-window attention and its ring cache, prefill and decode past the
window, paged decode, the loss and its gradients, train steps, the
serving engine, checkpoints and the launchers.

Routing is held equal exactly: the experts each token chose (``top_e``),
each choice's buffer slot and whether it was kept.  The reference's are
read by stand-ins for ``jax.lax.top_k`` and ``jnp.where`` in its module
that record what they return; the port's by wrapping ``moe.route`` and
``moe.dispatch_slots``.

Tolerances, normwise ``max|port - ref| <= tol * max|ref|``, as
``tests/test_torch_encdec.py`` sets them: fp32 1e-5 and bf16 4e-2 for the
forward and the layer's aux; the loss 1e-5 and every gradient leaf 1e-4;
after a train step ``mu``, ``nu``, ``cov``, the loss and gnorm 1e-5, the
parameters 1e-4 and their update 1e-3.  The reference's paged decode
reaches its Pallas kernel, which jax releases without ``pl.load`` cannot
run; those tests swap in its pure-jnp twin, ``paged_decode_attention_ref``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.kernels import paged_attn as ref_paged
from repro.models import common as RC
from repro.models import lm as RL
from repro.models import moe as RM
from repro.serve import engine as ref_engine
from repro.train import loop as RLOOP
from repro.train import optimizer as jopt
from repro_torch import convert, solvers
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import common as TC
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from repro_torch.serve import Engine, GenRequest
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as topt

MOE = ("mixtral_8x22b", "granite_moe_1b_a400m")
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
    for arch in MOE:
        for dtype in ("float32", "bfloat16"):
            rc, tc = cfgs(arch, dtype)
            params = RL.init_params(jax.random.PRNGKey(0), rc)
            out[arch, dtype] = (rc, tc, params, convert.lm_params_from_numpy(
                jax.tree.map(np.asarray, params), tc, device="cpu"))
    return out


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
class Spy:
    """A module stand-in: every attribute its module's, but those given."""

    def __init__(self, mod, **over):
        self._mod, self._over = mod, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._mod, name)


def spy_routing(monkeypatch):
    """Record the routing of the reference's and the port's ``_moe_local``
    calls: {"ref"|"port": {"top_e", "slot", "valid"}}, each a list with one
    entry a call ((T, k) for ``top_e``, (k, T) for the slots and masks)."""
    rec = {side: {"top_e": [], "slot": [], "valid": []} for side in ("ref", "port")}
    ref, port = rec["ref"], rec["port"]

    def top_k(x, k):  # once a call, before its slots
        vals, idx = jax.lax.top_k(x, k)
        ref["top_e"].append(np.asarray(idx))
        ref["slot"].append([])
        ref["valid"].append([])
        return vals, idx

    def where(cond, a, b):
        out = jnp.where(cond, a, b)
        # the slot's where(valid, ej * cap + rank_j, e * cap - 1), once a choice j
        if isinstance(b, int) and not isinstance(a, int):
            ref["slot"][-1].append(np.asarray(out))
            ref["valid"][-1].append(np.asarray(cond))
        return out

    monkeypatch.setattr(RM, "jax", Spy(jax, lax=Spy(jax.lax, top_k=top_k)))
    monkeypatch.setattr(RM, "jnp", Spy(jnp, where=where))
    route, dispatch = TM.route, TM.dispatch_slots

    def port_route(*a, **kw):
        out = route(*a, **kw)
        port["top_e"].append(out[2].numpy())
        return out

    def port_dispatch(*a, **kw):
        slot, valid = dispatch(*a, **kw)
        port["slot"].append(slot.numpy())
        port["valid"].append(valid.numpy())
        return slot, valid

    monkeypatch.setattr(TM, "route", port_route)
    monkeypatch.setattr(TM, "dispatch_slots", port_dispatch)
    return rec


def same_routing(rec, calls):
    for key in ("top_e", "slot", "valid"):
        assert len(rec["ref"][key]) == len(rec["port"][key]) == calls, key
        for a, b in zip(rec["port"][key], rec["ref"][key]):
            np.testing.assert_array_equal(a, np.stack(b) if key != "top_e" else b, err_msg=key)


def follow_the_reference(monkeypatch, dtype):
    """For the whole-model tests: the port's router takes the reference's
    choices, read in order from a ``jax.debug.callback`` in its module's
    ``top_k`` (the reference runs first).  In fp32 none may differ from the
    port's own.  In bf16 XLA's and PyTorch's roundings part the router's
    inputs by about a bf16 unit, enough to flip a near tie, and one flipped
    choice moves its row's logits by far more than the bf16 tolerance; a
    choice of the port's own that differs must be a near tie, its
    probability within 1e-2 of the reference's choice's.  Returns the
    count of differing choices a call."""
    ref_top, flips = [], []

    def top_k(x, k):
        vals, idx = jax.lax.top_k(x, k)
        jax.debug.callback(lambda i: ref_top.append(np.asarray(i)), idx, ordered=True)
        return vals, idx

    monkeypatch.setattr(RM, "jax", Spy(jax, lax=Spy(jax.lax, top_k=top_k)))
    route = TM.route

    def port_route(p, xt, cfg):
        probs, _, own = route(p, xt, cfg)
        jax.effects_barrier()
        want = torch.from_numpy(np.array(ref_top.pop(0))).long()
        top_p, differ, gap = TM.replay_choices(probs, own, want)
        flips.append(differ)
        assert gap <= (1e-2 if dtype == "bfloat16" else 0.0), f"a choice {gap:.2e} from the reference's"
        return probs, top_p, want

    monkeypatch.setattr(TM, "route", port_route)
    return flips


def moe_layer(arch, dtype, seed=0, **kw):
    """A layer's reference params and the port's MoE module holding them."""
    rc, tc = cfgs(arch, dtype, **kw)
    p = RM.init_moe(jax.random.PRNGKey(seed), rc)
    p = {k: v[0] for k, v in p.items()}  # (array, axes) → array
    mod = TM.init_moe(torch.Generator().manual_seed(0), tc)
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(t(np.asarray(v)))
    return rc, tc, p, mod


ROUTINGS = {"reduced": {}, "granite-routing": dict(num_experts=32, experts_per_token=8)}


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_routes_and_computes_as_the_reference(arch, routing, dtype, monkeypatch):
    rc, tc, p, mod = moe_layer(arch, dtype, **ROUTINGS[routing])
    x = np.random.default_rng(1).standard_normal((40, rc.d_model)).astype(np.float32)
    rec = spy_routing(monkeypatch)
    want, waux = RM._moe_local(p, j(x, dtype), rc)
    got, gaux = TM._moe_local(mod, t(x, dtype), tc)
    same_routing(rec, 1)
    assert got.dtype == getattr(torch, dtype) and gaux.dtype == torch.float32
    close(got, want, TOL[dtype])
    close(gaux, waux, TOL[dtype])


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_a_router_sending_every_token_to_one_expert_drops_tokens(routing, monkeypatch):
    rc, tc, p, mod = moe_layer("granite_moe_1b_a400m", "float32", **ROUTINGS[routing])
    x = np.abs(np.random.default_rng(2).standard_normal((24, rc.d_model))).astype(np.float32)
    router = np.zeros((rc.d_model, rc.num_experts), np.float32)
    router[:, 1] = 1.0  # expert 1 first for every token, far ahead of the others
    router[:, 0] = np.linspace(-1e-3, 1e-3, rc.d_model)
    p["router"] = j(router)
    with torch.no_grad():
        mod.router.copy_(t(router))
    rec = spy_routing(monkeypatch)
    want, waux = RM._moe_local(p, j(x), rc)
    got, gaux = TM._moe_local(mod, t(x), tc)
    same_routing(rec, 1)
    cap = max(int(rc.moe_capacity_factor * 24 * rc.experts_per_token / rc.num_experts), 1)
    valid = rec["port"]["valid"][0]
    assert (rec["port"]["top_e"][0][:, 0] == 1).all() and valid[0].sum() == cap < 24
    close(got, want, 1e-5)
    close(gaux, waux, 1e-5)


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_equal_probabilities_take_the_lower_expert_first(routing, monkeypatch):
    rc, tc, p, mod = moe_layer("mixtral_8x22b", "float32", **ROUTINGS[routing])
    x = np.random.default_rng(3).standard_normal((12, rc.d_model)).astype(np.float32)
    router = np.random.default_rng(4).standard_normal((rc.d_model, rc.num_experts)).astype(np.float32)
    x[::3] = 0.0  # every third token: equal logits, so equal probabilities
    p["router"] = j(router)
    with torch.no_grad():
        mod.router.copy_(t(router))
    rec = spy_routing(monkeypatch)
    want, waux = RM._moe_local(p, j(x), rc)
    got, gaux = TM._moe_local(mod, t(x), tc)
    same_routing(rec, 1)
    k = rc.experts_per_token
    np.testing.assert_array_equal(rec["port"]["top_e"][0][::3], np.tile(np.arange(k), (4, 1)))
    # torch.topk need not break the tie the same way; the stable sort does
    probs = torch.softmax(t(x) @ t(router), -1)
    assert torch.equal(probs[0], probs[0, :1].expand(rc.num_experts))
    close(got, want, 1e-5)
    close(gaux, waux, 1e-5)


@pytest.mark.parametrize("tokens,group", [(40, 16), (32, 16), (12, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_path_with_a_padded_tail(tokens, group, dtype):
    # 40 tokens: groups of 16, 16 and a tail of 8 real rows (valid_count);
    # 32: two full groups; 12: one call of the local path
    rc, tc, p, mod = moe_layer("granite_moe_1b_a400m", dtype, **ROUTINGS["granite-routing"])
    x = np.random.default_rng(5).standard_normal((tokens, rc.d_model)).astype(np.float32)
    want, waux = RM._moe_grouped(p, j(x, dtype), rc, group_tokens=group)
    got, gaux = TM._moe_grouped(mod, t(x, dtype), tc, group_tokens=group)
    assert got.shape == (tokens, rc.d_model)
    close(got, want, TOL[dtype])
    close(gaux, waux, TOL[dtype])


@pytest.mark.parametrize("count", [16, 9, 1])
def test_a_padded_groups_valid_count_routes_as_the_reference(count, monkeypatch):
    rc, tc, p, mod = moe_layer("granite_moe_1b_a400m", "float32", **ROUTINGS["granite-routing"])
    x = np.random.default_rng(6).standard_normal((16, rc.d_model)).astype(np.float32)
    x[count:] = 0.0  # the zero pad of a tail group
    rec = spy_routing(monkeypatch)
    want, waux = RM._moe_local(p, j(x), rc, valid_count=jnp.int32(count))
    got, gaux = TM._moe_local(mod, t(x), tc, valid_count=count)
    same_routing(rec, 1)
    assert not rec["port"]["valid"][0][:, count:].any()
    close(got, want, 1e-5)
    close(gaux, waux, 1e-5)


def test_apply_moe_matches_and_a_mesh_raises():
    rc, tc, p, mod = moe_layer("mixtral_8x22b", "float32")
    x = np.random.default_rng(7).standard_normal((2, 9, rc.d_model)).astype(np.float32)
    want, waux = RM.apply_moe(p, j(x), rc)
    got, gaux = TM.apply_moe(mod, t(x), tc)
    close(got, want, 1e-5)
    close(gaux, waux, 1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        TM.apply_moe(mod, t(x), tc, mesh=object())


def test_moe_init_layout():
    for arch in MOE:
        rc, tc = cfgs(arch, "bfloat16")
        want = {k: (v[0].shape, str(v[0].dtype)) for k, v in RM.init_moe(jax.random.PRNGKey(0), rc).items()}
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in TM.init_moe(torch.Generator().manual_seed(0), tc).named_parameters()}
        assert got == want
        assert got["router"][1] == "float32"


# ---------------------------------------------------------------------------
# sliding-window attention and its ring cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_chunk", [64, 16])  # one chunk; the online softmax over several
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_with_a_window(kv_chunk, dtype):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    kpos = pos.copy()
    kpos[3] = -1  # an empty slot
    for window in (7, 32):
        want = RC.attention(j(q, dtype), j(k, dtype), j(v, dtype), q_positions=j(pos), kv_positions=j(kpos),
                            causal=True, window=window, kv_chunk=kv_chunk)
        got = TC.attention(t(q, dtype), t(k, dtype), t(v, dtype), q_positions=t(pos), kv_positions=t(kpos),
                           causal=True, window=window, kv_chunk=kv_chunk)
        close(got, want, TOL[dtype])


@pytest.mark.parametrize("s", [5, 8, 8 + 3, 8 * 2 + 5])  # s < w, s = w, s > w with w ∤ s
def test_build_cache_ring(s):
    rc, tc = cfgs("mixtral_8x22b", sliding_window=8)
    rng = np.random.default_rng(9)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32) + 3
    for cache_len in (30, 6):  # w = the window, and w = cache_len under it
        want = RC._build_cache(rc, j(k), j(v), j(pos), cache_len)
        got = TC._build_cache(tc, t(k), t(v), t(pos), cache_len)
        for key in ("k", "v", "pos"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert tuple(TC.init_attention_cache(tc, 2, 30, torch.float32)["k"].shape) == (2, 8, 2, 16)
    assert tuple(TC.init_attention_cache(tc, 2, 5, torch.float32)["pos"].shape) == (2, 5)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_past_the_window(models, arch, dtype, monkeypatch):
    rc, tc, params, model = models[arch, dtype]
    flips = follow_the_reference(monkeypatch, dtype)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, rc.vocab_size, (2, 36)).astype(np.int32)
    last = np.array([35, 29], np.int32)
    wcache, wl = RL.prefill(params, {"tokens": j(toks)}, rc, cache_len=80, last=j(last))
    gcache, gl = TL.prefill(model, {"tokens": toks}, tc, cache_len=80, last=last)
    close(gl, wl, TOL[dtype])
    sc = 32 if rc.sliding_window else 80
    assert tuple(gcache["attn"]["k"].shape) == (rc.num_layers, 2, sc, rc.num_kv_heads, rc.resolved_head_dim)
    np.testing.assert_array_equal(gcache["attn"]["pos"].numpy(), np.asarray(wcache["attn"]["pos"]))
    close(gcache["attn"]["k"], wcache["attn"]["k"], TOL[dtype])
    pos = last + 1
    for step in range(6):  # row 1 passes position 32, row 0 wraps its ring
        nxt = rng.integers(0, rc.vocab_size, (2, 1)).astype(np.int32)
        wcache, wl = RL.decode_step(params, wcache, j(nxt), j(pos), rc)
        gcache, gl = TL.decode_step(model, gcache, nxt, pos, tc)
        close(gl, wl, TOL[dtype])
        pos = pos + 1
    np.testing.assert_array_equal(gcache["attn"]["pos"].numpy(), np.asarray(wcache["attn"]["pos"]))
    close(gcache["attn"]["v"], wcache["attn"]["v"], TOL[dtype])
    assert len(flips) == 7 * rc.num_layers and (dtype == "bfloat16" or sum(flips) == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_granite_prefill_and_paged_decode_steps(models, dtype, monkeypatch):
    monkeypatch.setattr(ref_paged, "paged_decode_attention", ref_paged.paged_decode_attention_ref)
    rc, tc, params, model = models["granite_moe_1b_a400m", dtype]
    flips = follow_the_reference(monkeypatch, dtype)
    rng = np.random.default_rng(11)
    page, s = 4, 10
    toks = rng.integers(0, rc.vocab_size, (2, s)).astype(np.int32)
    last = np.array([9, 5], np.int32)
    wraw, wl = RL.prefill(params, {"tokens": j(toks)}, rc, last=j(last), raw_kv=True)
    graw, gl = TL.prefill(model, {"tokens": toks}, tc, last=last, raw_kv=True)
    close(gl, wl, TOL[dtype])
    table = np.array([[1, 2, 3, 4], [5, 6, -1, 8]], np.int32)
    wcache = RL.init_paged_caches(rc, 2, 9, page)
    gcache = TL.init_paged_caches(tc, 2, 9, page, device="cpu")
    for n in ("k", "v"):
        fresh = np.asarray(wraw["attn"][n].astype(jnp.float32))
        close(graw["attn"][n], fresh, TOL[dtype])
        pool = np.zeros(wcache["attn"][f"{n}_pages"].shape, np.float32)
        for r in range(2):
            rows = np.pad(fresh[:, r], ((0, 0), (0, 3 * page - s), (0, 0), (0, 0)))
            for i in range(3):
                if table[r, i] >= 0:
                    pool[:, table[r, i]] = rows[:, i * page:(i + 1) * page]
        wcache["attn"][f"{n}_pages"] = j(pool, dtype)
        gcache["attn"][f"{n}_pages"] = t(pool, dtype)
    pos = last + 1
    for step in range(4):
        nxt = rng.integers(0, rc.vocab_size, (2, 1)).astype(np.int32)
        wcache, wl = RL.decode_step(params, wcache, j(nxt), j(pos), rc, page_table=j(table))
        gcache, gl = TL.decode_step(model, gcache, nxt, pos, tc, page_table=t(table))
        close(gl, wl, TOL[dtype])
        pos = pos + 1
    close(gcache["attn"]["k_pages"], wcache["attn"]["k_pages"], TOL[dtype])
    assert len(flips) == 5 * rc.num_layers and (dtype == "bfloat16" or sum(flips) == 0)


def test_mixtral_caches_cannot_be_paged():
    _, tc = cfgs("mixtral_8x22b")
    with pytest.raises(ValueError, match="sliding-window"):
        TL.init_paged_caches(tc, 2, 9, 4, device="cpu")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trainees():
    """arch → (ref cfg, port cfg, ref params, their numpy tree), fp32."""
    out = {}
    for arch in MOE:
        rc, tc = cfgs(arch)
        params = RL.init_params(jax.random.PRNGKey(1), rc)
        out[arch] = (rc, tc, params, jax.tree.map(np.asarray, params))
    return out


def tokens_of(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE)
def test_train_loss_metrics_and_every_gradient_leaf_match_the_reference(trainees, arch):
    rc, tc, params, tree = trainees[arch]
    toks = tokens_of(3, 40, 12)
    fn = jax.jit(jax.value_and_grad(lambda p, b: RL.train_loss(p, b, rc), has_aux=True))
    (want, wmet), wgrad = fn(params, {"tokens": j(toks)})
    tp = TL.train_params(convert.lm_params_from_numpy(tree, tc, device="cpu"))
    loss, met = TL.train_loss(tp, {"tokens": toks}, tc)
    grads = torch.autograd.grad(loss, list(tp.values()), retain_graph=True)
    close(loss, want, 1e-5)
    assert set(met) == set(wmet) == {"ce", "aux"}
    close(met["ce"], wmet["ce"], 1e-5)
    close(met["aux"], wmet["aux"], 1e-5)
    assert float(met["aux"].detach()) > 1.0  # the layers' balance losses, summed
    wg = leaves(wgrad)
    assert list(tp) == list(wg)
    assert {"blocks.moe.router", "blocks.moe.wd", "blocks.moe.wg", "blocks.moe.wu"} <= set(tp)
    for (name, p), g in zip(tp.items(), grads):
        assert g.shape == p.shape
        close(g, wg[name], 1e-4)
    # the router learns from the aux loss alone too, through the checkpointed layers
    gaux = torch.autograd.grad(met["aux"], [tp["blocks.moe.router"]])[0]
    assert float(gaux.abs().max()) > 0


@pytest.mark.parametrize("arch,groups", [("granite_moe_1b_a400m", {24: 2, 1024: 2}),
                                         ("mixtral_8x22b", {56: 2})])
def test_the_optimizers_decay_and_precondition_exactly_the_references_leaves(arch, groups):
    # at full width: granite's embed and unembed (vocab 49280 padded) make an
    # order-1024 group, the stacked norm scales (24, 1024) an order-24 one;
    # mixtral's embed (32768, 6144) is past the order cap; the routers (3-D)
    # and the experts (4-D) are decayed, not preconditioned
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
    assert shapes["blocks.moe.router"][1] == torch.float32 and len(shapes["blocks.moe.wg"][0]) == 4
    decayed = {k for k, m in zip(shapes, metas) if m.ndim >= 2}
    assert decayed == {k for k, v in ref.items() if v.ndim >= 2} >= {"blocks.moe.router", "blocks.moe.wd"}


def ref_optimizer(name):
    return jopt.get_optimizer(name, jopt.warmup_cosine(1e-2, 2, 10), max_grad_norm=1.0)


def port_optimizer(name):
    return lambda ps: topt.get_optimizer(name, ps, topt.warmup_cosine(1e-2, 2, 10), max_grad_norm=1.0)


@pytest.mark.parametrize("arch,microbatches", [("granite_moe_1b_a400m", 1), ("granite_moe_1b_a400m", 2),
                                               ("mixtral_8x22b", 1)])
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_one_train_step_matches_the_reference_from_its_state(trainees, arch, name, microbatches):
    rc, tc, params, _ = trainees[arch]
    jo = ref_optimizer(name)
    step = jax.jit(RLOOP.make_train_step(rc, jo, microbatches=microbatches))
    t1, t2 = tokens_of(4, 40, 13), tokens_of(4, 40, 14)  # past mixtral's window of 32
    p1, s1, _ = step(params, jo.init(params), {"tokens": j(t1)})
    p2, s2, wmet = step(p1, s1, {"tokens": j(t2)})
    state = {k: jax.tree.map(np.asarray, v) for k, v in s1.items()}
    named, opt = convert.train_state_from_numpy(jax.tree.map(np.asarray, p1), state, tc,
                                                port_optimizer(name), device="cpu")
    before = {k: p.detach().clone() for k, p in named.items()}
    met = TLOOP.make_train_step(tc, opt, microbatches=microbatches)(named, {"tokens": torch.from_numpy(t2)})
    for key in ("loss", "gnorm", "ce", "aux"):
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


@pytest.mark.parametrize("arch", MOE)
def test_the_ebv_step_solves_the_references_order_groups(trainees, arch):
    rc, tc, params, tree = trainees[arch]
    named, opt = convert.train_state_from_numpy(tree, None, tc, port_optimizer("ebv"), device="cpu")
    with solvers.record_dispatches() as log:
        TLOOP.make_train_step(tc, opt)(named, {"tokens": torch.from_numpy(tokens_of(2, 16, 15))})
    # order 2 (the two stacked norm scales, L = 2), then order 64 (embed, unembed)
    assert [(pr.op, pr.n, pr.batch) for pr, _ in log] == [
        ("factor", 2, 2), ("solve", 2, 2), ("factor", 64, 2), ("solve", 64, 2)]


def test_make_batch_fn_gives_the_tokens():
    cfg = get_config("granite_moe_1b_a400m").reduced()
    toks = tokens_of(4, 18, 16)
    batch = TLOOP.make_batch_fn(cfg, TLOOP.TrainConfig(), device="cpu")(toks)
    want = RLOOP.make_batch_fn(ref_config("granite_moe_1b_a400m").reduced(), RLOOP.TrainConfig())(toks)
    assert sorted(batch) == sorted(want) == ["tokens"]
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.asarray(want["tokens"]))


@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_four_steps_of_train_match_the_reference(trainees, name):
    rc, tc, params, tree = trainees["granite_moe_1b_a400m"]
    kw = dict(steps=4, seq_len=24, global_batch=4, warmup_steps=2, optimizer=name, learning_rate=1e-2)
    _, want = RLOOP.train(rc, RLOOP.TrainConfig(**kw), params=jax.tree.map(jnp.copy, params))
    _, got = TLOOP.train(tc, TLOOP.TrainConfig(**kw), device="cpu",
                         params=TL.train_params(convert.lm_params_from_numpy(tree, tc, device="cpu")))
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2, 3]
    close([h["loss"] for h in got], [h["loss"] for h in want], 1e-4)
    close([h["aux"] for h in got], [h["aux"] for h in want], 1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def requests(kind, vocab, shapes):
    rng = np.random.default_rng(17)
    return [kind(tokens=rng.integers(0, vocab, (s,)).astype(np.int32), max_new_tokens=n, seed=i)
            for i, (s, n) in enumerate(shapes)]


def stats_of(st):
    return (st.prefill_dispatches, st.decode_dispatches, st.generated_tokens, st.padding_frac,
            st.peak_active, st.events)


# mixtral: prompts of 30 (bucket 32, inside the window of 32), 37 and 45
# (buckets past it: prefilled at their exact length) and 12, each decoding
# past position 32; granite: short prompts in buckets of 4
SERVED = {"mixtral_8x22b": ([(30, 6), (37, 9), (12, 25), (45, 4)], dict(max_len=96, slots=2, bucket=8)),
          "granite_moe_1b_a400m": ([(5, 4), (8, 2), (3, 6), (11, 5)], dict(max_len=64, slots=2, bucket=4))}


@pytest.mark.parametrize("arch,paged", [("mixtral_8x22b", False), ("granite_moe_1b_a400m", False),
                                        ("granite_moe_1b_a400m", True)])
def test_greedy_serve_equals_the_reference_engine(models, arch, paged, monkeypatch):
    monkeypatch.setattr(ref_paged, "paged_decode_attention", ref_paged.paged_decode_attention_ref)
    rc, tc, params, model = models[arch, "float32"]
    shapes, kw = SERVED[arch]
    kw = dict(kw, **(dict(paged=True, page_size=16) if paged else {}))
    ref = ref_engine.Engine(params, rc, **kw)
    want = ref.serve(requests(ref_engine.GenRequest, rc.vocab_size, shapes))
    eng = Engine(model, tc, **kw)
    got = eng.serve(requests(GenRequest, tc.vocab_size, shapes))
    assert len(got) == len(want) == len(shapes)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"request {i}")
    assert stats_of(eng.stats) == stats_of(ref.stats)
    if paged:
        assert eng.prefix_cache is None and ref.prefix_cache is None  # prefix reuse: dense family only
    for s0, _ in shapes:
        assert eng._bucket_len(s0, None) == ref._bucket_len(s0, None)


def test_mixtral_prompts_past_the_window_are_prefilled_at_their_length(models):
    _, tc, _, model = models["mixtral_8x22b", "float32"]
    eng = Engine(model, tc, max_len=96, slots=2, bucket=8)
    assert [eng._bucket_len(s, None) for s in (30, 32, 33, 37, 45)] == [32, 32, 33, 37, 45]
    with pytest.raises(ValueError, match="sliding-window"):
        Engine(model, tc, max_len=96, paged=True, page_size=8)


def test_granite_paged_serve_is_bitwise_the_dense_serve(models):
    _, tc, _, model = models["granite_moe_1b_a400m", "bfloat16"]
    shapes, kw = SERVED["granite_moe_1b_a400m"]
    reqs = requests(GenRequest, tc.vocab_size, shapes)
    dense = Engine(model, tc, **kw).serve(reqs)
    paged = Engine(model, tc, **kw, paged=True, page_size=8).serve(reqs)
    for a, b in zip(dense, paged):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints and the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["adamw", "ebv"])
def test_a_moe_train_state_round_trips_bit_for_bit(tmp_path, name):
    cfg = get_config("granite_moe_1b_a400m").reduced().replace(dtype="bfloat16")
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
    assert fresh["blocks.moe.router"].dtype == torch.float32 and fresh["blocks.moe.wg"].ndim == 4
    bits = lambda x: x.view(torch.int16) if x.dtype == torch.bfloat16 else x
    for k, p in params.items():
        q = fresh[k]
        assert q.dtype == p.dtype and torch.equal(bits(q), bits(p)), k
        for key in ("mu", "nu") + (("cov",) if name == "ebv" else ()):
            assert torch.equal(fopt.state[q][key], opt.state[p][key]), (k, key)
        assert fopt.state[q]["step"] == opt.state[p]["step"] == 1


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("optimizer", ["adamw", "ebv"])
def test_the_training_launcher_trains_the_moe_family_on_the_cpu(arch, optimizer, capsys):
    launch_train.main(["--arch", arch, "--reduced", "--steps", "3", "--device", "cpu",
                       "--optimizer", optimizer, "--seq-len", "40", "--batch", "4"])
    assert "[train] step     0 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch,paged", [("mixtral_8x22b", False), ("granite_moe_1b_a400m", False),
                                        ("granite_moe_1b_a400m", True)])
def test_the_serving_launcher_serves_the_moe_family_on_the_cpu(arch, paged, capsys):
    launch_serve.main(["--device", "cpu", "--arch", arch, "--reduced", "--batch", "3", "--ragged",
                       "--slots", "2", "--prompt-len", "40"] + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert ("prefix reuse: 0 warm admissions" in out) == paged
