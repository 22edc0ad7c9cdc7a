"""The port's LM substrate (``repro_torch.models``) against the reference's
``repro.models`` on the same inputs and weights, on the CPU.

Inputs are drawn with numpy from a seed; the reference's parameter tree is
carried across by ``repro_torch.convert.lm_params_from_numpy``.
Tolerances, normwise ``max|port - ref| <= tol * max|ref|``:

* fp32: 1e-5 (XLA's and PyTorch's CPU products and transcendentals round
  alike up to a few ulps);
* bf16: 4e-2, a few bf16 units (2^-8 each): both frameworks round every
  bf16 activation, but at other places (XLA fuses elementwise chains in
  fp32), and the flips compound through the layers.

The reference's paged decode reaches its Pallas kernel, which jax releases
without ``pl.load`` cannot run; those tests swap in its pure-jnp twin,
``paged_decode_attention_ref``, for the duration of the test.
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
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import lm as TL

TOL = {"float32": 1e-5, "bfloat16": 4e-2}
DENSE = ("llama3_8b", "starcoder2_3b", "nemotron_4_340b")


def close(got, want, dtype="float32"):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want).astype(np.float32), np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= TOL[dtype], f"normwise {err:.3e} > {TOL[dtype]}"


def t(x, dtype=None):
    out = convert.tensor_from_numpy(np.asarray(x), device="cpu")
    return out if dtype is None else out.to(getattr(torch, dtype))


def j(x, dtype=None):
    return jnp.asarray(x) if dtype is None else jnp.asarray(x, jnp.dtype(dtype))


def cfgs(arch, dtype="float32"):
    return ref_config(arch).reduced().replace(dtype=dtype), get_config(arch).reduced().replace(dtype=dtype)


@pytest.fixture(scope="module")
def models():
    """(arch, dtype) → (ref cfg, port cfg, ref params, port model)."""
    out = {}
    for arch in DENSE:
        for dtype in ("float32", "bfloat16"):
            rc, tc = cfgs(arch, dtype)
            params = RL.init_params(jax.random.PRNGKey(0), rc)
            tree = jax.tree.map(np.asarray, params)
            out[arch, dtype] = (rc, tc, params, convert.lm_params_from_numpy(tree, tc, device="cpu"))
    return out


def test_configs_equal_the_reference():
    import dataclasses

    for arch in ARCH_IDS:
        for cfg, rc in ((get_config(arch), ref_config(arch)),
                        (get_config(arch).reduced(), ref_config(arch).reduced())):
            assert dataclasses.asdict(cfg) == dataclasses.asdict(rc), arch


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(kind, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 0.5
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = RC.apply_norm({"scale": j(scale)}, j(x, dtype), kind)
    norm = TC.Norm(64)
    norm.scale.data = t(scale)
    got = TC.apply_norm(norm, t(x, dtype), kind)
    assert str(got.dtype).endswith(dtype)
    close(got, want, dtype)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    close(TC.apply_rope(t(x), t(pos), theta), RC.apply_rope(j(x), j(pos), theta))


@pytest.mark.parametrize("kv_chunk", [64, 8, 5])  # one chunk; several; several with a ragged tail
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_one_and_several_chunks(kv_chunk, dtype):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    qpos = np.arange(12, dtype=np.int32)
    kvpos = qpos.copy()
    kvpos[9:] = -1  # empty slots
    kw = dict(causal=True, window=None, kv_chunk=kv_chunk)
    want = RC.attention(j(q, dtype), j(k, dtype), j(v, dtype), q_positions=j(qpos),
                        kv_positions=j(kvpos), **kw)
    got = TC.attention(t(q, dtype), t(k, dtype), t(v, dtype), q_positions=t(qpos),
                       kv_positions=t(kvpos), **kw)
    close(got, want, dtype)


def _layer(models, arch, dtype):
    rc, tc, params, model = models[arch, dtype]
    lp = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    return rc, tc, lp, model.blocks[0].attn


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_layer_prefill(models, arch, dtype):
    rc, tc, lp, tp = _layer(models, arch, dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, rc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want, wc = RC.apply_attention_layer(lp, j(x, dtype), rc, positions=j(pos), mode="prefill",
                                        cache_len=16)
    got, gc = TC.apply_attention_layer(tp, t(x, dtype), tc, positions=t(pos), mode="prefill",
                                       cache_len=16)
    close(got, want, dtype)
    for key in ("k", "v"):
        close(gc[key], wc[key], dtype)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_layer_prefill_with_prior_and_raw_kv(models, dtype):
    rc, tc, lp, tp = _layer(models, "llama3_8b", dtype)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 6, rc.d_model)).astype(np.float32)
    prior = {n: rng.standard_normal((1, 8, rc.num_kv_heads, rc.resolved_head_dim)).astype(np.float32)
             for n in ("k", "v")}
    pos = np.arange(8, 14, dtype=np.int32)[None]
    want, wc = RC.apply_attention_layer(lp, j(x, dtype), rc, positions=j(pos), mode="prefill",
                                        seq_positions=j(pos[0]), raw_kv=True,
                                        prior={n: j(a, dtype) for n, a in prior.items()})
    got, gc = TC.apply_attention_layer(tp, t(x, dtype), tc, positions=t(pos), mode="prefill",
                                       seq_positions=t(pos[0]), raw_kv=True,
                                       prior={n: t(a, dtype) for n, a in prior.items()})
    close(got, want, dtype)
    assert sorted(gc) == ["k", "v"]
    for key in ("k", "v"):
        close(gc[key], wc[key], dtype)


def _dense_cache(rng, rc, b, sc, fill):
    kv, dh = rc.num_kv_heads, rc.resolved_head_dim
    k = rng.standard_normal((b, sc, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sc, kv, dh)).astype(np.float32)
    pos = np.full((b, sc), -1, np.int32)
    for r, n in enumerate(fill):
        pos[r, :n] = np.arange(n)
    return k, v, pos


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_layer_dense_decode(models, arch, dtype):
    rc, tc, lp, tp = _layer(models, arch, dtype)
    rng = np.random.default_rng(6)
    fill = [5, 11, 1]
    k, v, pos = _dense_cache(rng, rc, 3, 16, fill)
    x = rng.standard_normal((3, 1, rc.d_model)).astype(np.float32)
    cur = np.asarray(fill, np.int32)
    want, wc = RC.apply_attention_layer(
        lp, j(x, dtype), rc, positions=j(cur[:, None]), seq_positions=j(cur), mode="decode",
        cache={"k": j(k, dtype), "v": j(v, dtype), "pos": j(pos)})
    cache = {"k": t(k, dtype), "v": t(v, dtype), "pos": t(pos)}
    got, gc = TC.apply_attention_layer(tp, t(x, dtype), tc, positions=t(cur[:, None]),
                                       seq_positions=t(cur), mode="decode", cache=cache)
    close(got, want, dtype)
    assert gc is cache  # updated in place
    for key in ("k", "v"):
        close(gc[key], wc[key], dtype)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_layer_paged_decode(models, dtype, monkeypatch):
    monkeypatch.setattr(ref_paged, "paged_decode_attention", ref_paged.paged_decode_attention_ref)
    rc, tc, lp, tp = _layer(models, "llama3_8b", dtype)
    rng = np.random.default_rng(7)
    kv, dh, page = rc.num_kv_heads, rc.resolved_head_dim, 4
    kp = rng.standard_normal((12, page, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((12, page, kv, dh)).astype(np.float32)
    table = np.array([[3, 5, 0, 0], [7, -1, 2, 9], [0, 0, 0, 0]], np.int32)  # a hole; an idle row
    cur = np.array([6, 13, 2], np.int32)
    x = rng.standard_normal((3, 1, rc.d_model)).astype(np.float32)
    want, wc = RC.apply_attention_layer(
        lp, j(x, dtype), rc, positions=j(cur[:, None]), seq_positions=j(cur), mode="decode",
        cache={"k_pages": j(kp, dtype), "v_pages": j(vp, dtype)}, page_table=j(table))
    cache = {"k_pages": t(kp, dtype), "v_pages": t(vp, dtype)}
    got, gc = TC.apply_attention_layer(tp, t(x, dtype), tc, positions=t(cur[:, None]),
                                       seq_positions=t(cur), mode="decode", cache=cache,
                                       page_table=t(table))
    close(got, want, dtype)
    for key in ("k_pages", "v_pages"):
        close(gc[key], wc[key], dtype)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_step(models, arch, dtype):
    rc, tc, params, model = models[arch, dtype]
    rng = np.random.default_rng(8)
    toks = rng.integers(0, rc.vocab_size, (2, 10)).astype(np.int32)
    last = np.array([9, 6], np.int32)
    wcache, wl = RL.prefill(params, {"tokens": j(toks)}, rc, cache_len=16, last=j(last))
    gcache, gl = TL.prefill(model, {"tokens": toks}, tc, cache_len=16, last=last)
    assert gl.dtype == torch.float32 and gl.shape == (2, 1, TL.padded_vocab_size(tc))
    close(gl, wl, dtype)
    for key in ("k", "v"):
        close(gcache["attn"][key], wcache["attn"][key], dtype)
    np.testing.assert_array_equal(gcache["attn"]["pos"].numpy(), np.asarray(wcache["attn"]["pos"]))
    nxt = rng.integers(0, rc.vocab_size, (2, 1)).astype(np.int32)
    pos = np.array([10, 10], np.int32)
    for _ in range(2):
        wcache, wl = RL.decode_step(params, wcache, j(nxt), j(pos), rc)
        gcache, gl = TL.decode_step(model, gcache, nxt, pos, tc)
        close(gl, wl, dtype)
        pos = pos + 1
    close(gcache["attn"]["k"], wcache["attn"]["k"], dtype)


def test_prefill_with_a_prior_prefix(models):
    rc, tc, params, model = models["llama3_8b", "float32"]
    rng = np.random.default_rng(9)
    toks = rng.integers(0, rc.vocab_size, (1, 12)).astype(np.int32)
    wfull, _ = RL.prefill(params, {"tokens": j(toks[:, :8])}, rc, raw_kv=True)
    prior = {"k": wfull["attn"]["k"], "v": wfull["attn"]["v"]}
    wc, wl = RL.prefill(params, {"tokens": j(toks[:, 8:])}, rc, prior=prior, raw_kv=True,
                        last=j(np.array([3], np.int32)))
    gc, gl = TL.prefill(model, {"tokens": toks[:, 8:]}, tc, raw_kv=True, last=np.array([3]),
                        prior={n: t(np.asarray(a)) for n, a in prior.items()})
    close(gl, wl)
    close(gc["attn"]["k"], wc["attn"]["k"])


def test_paged_decode_step(models, monkeypatch):
    monkeypatch.setattr(ref_paged, "paged_decode_attention", ref_paged.paged_decode_attention_ref)
    rc, tc, params, model = models["llama3_8b", "float32"]
    rng = np.random.default_rng(10)
    wcache = RL.init_paged_caches(rc, 2, 9, 4)
    gcache = TL.init_paged_caches(tc, 2, 9, 4, device="cpu")
    assert gcache["attn"]["k_pages"].shape == tuple(wcache["attn"]["k_pages"].shape)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos = np.array([0, 3], np.int32)
    for _ in range(3):
        nxt = rng.integers(0, rc.vocab_size, (2, 1)).astype(np.int32)
        wcache, wl = RL.decode_step(params, wcache, j(nxt), j(pos), rc, page_table=j(table))
        gcache, gl = TL.decode_step(model, gcache, nxt, pos, tc, page_table=t(table))
        close(gl, wl)
        pos = pos + 1
    close(gcache["attn"]["v_pages"], wcache["attn"]["v_pages"])


def test_init_caches_match_the_reference():
    rc, tc = cfgs("llama3_8b")
    want = RL.init_caches(rc, 3, 20)["attn"]
    got = TL.init_caches(tc, 3, 20, device="cpu")["attn"]
    for key in ("k", "v", "pos"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_init_params_layout_and_seed():
    _, tc = cfgs("llama3_8b", "bfloat16")
    a, b = TL.init_params(0, tc, device="cpu"), TL.init_params(0, tc, device="cpu")
    assert a.embed.shape == (TL.padded_vocab_size(tc), tc.d_model) and a.embed.dtype == torch.bfloat16
    assert a.blocks[0].attn.wq.shape == (tc.d_model, tc.num_heads * tc.resolved_head_dim)
    assert a.blocks[0].ln_attn.scale.dtype == torch.float32 and len(a.blocks) == tc.num_layers
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_init_params_layout_and_seed_encdec():
    # whisper: the decoder blocks gain ln_cross and cross, beside one encoder
    # block (the dense block) per encoder layer and enc_ln_f
    rc, tc = cfgs("whisper_tiny", "bfloat16")
    a, b = TL.init_params(0, tc, device="cpu"), TL.init_params(0, tc, device="cpu")
    assert len(a.blocks) == tc.num_layers and len(a.enc_blocks) == tc.encoder_layers
    hd, kvd = tc.num_heads * tc.resolved_head_dim, tc.num_kv_heads * tc.resolved_head_dim
    dec = {n: (tuple(p.shape), p.dtype) for n, p in a.blocks[0].named_parameters()}
    enc = {n: (tuple(p.shape), p.dtype) for n, p in a.enc_blocks[0].named_parameters()}
    assert dec["cross.wq"] == ((tc.d_model, hd), torch.bfloat16)
    assert dec["cross.wk"] == dec["cross.wv"] == ((tc.d_model, kvd), torch.bfloat16)
    assert dec["ln_cross.scale"] == ((tc.d_model,), torch.float32)
    assert set(dec) - set(enc) == {"cross.wq", "cross.wk", "cross.wv", "cross.wo", "ln_cross.scale"}
    assert set(enc) == {"attn.wq", "attn.wk", "attn.wv", "attn.wo", "ln_attn.scale", "ln_mlp.scale",
                        "mlp.wu", "mlp.wd"}  # whisper's MLP is not gated
    assert a.enc_ln_f.scale.shape == (tc.d_model,) and a.enc_ln_f.scale.dtype == torch.float32
    # the reference's tree, leaf for leaf
    want = convert.named_leaves(jax.tree.map(np.asarray, RL.init_params(jax.random.PRNGKey(0), rc)))
    got = {}
    for name, p in a.named_parameters():
        parts = name.split(".")
        if parts[0] in ("blocks", "enc_blocks"):
            name = ".".join(parts[:1] + parts[2:])
            got[name] = (len(getattr(a, parts[0])),) + tuple(p.shape)
        else:
            got[name] = tuple(p.shape)
    assert got == {k: v.shape for k, v in want.items()}
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    c = TL.init_params(1, tc, device="cpu")
    assert not torch.equal(a.enc_blocks[0].attn.wq, c.enc_blocks[0].attn.wq)


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "hymba_1_5b", "qwen2_vl_2b"])
def test_unported_families_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        TL.init_params(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        TB.init_block_cache(cfg, 1, 8, torch.float32, device="cpu")


def test_unported_features_raise():
    _, tc = cfgs("llama3_8b")
    x = torch.zeros((1, 4, 2, 16))
    pos = torch.arange(4)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        TC.apply_rope(x, pos[None], 1e4, mrope_sections=(2, 3, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        TC.attention(x, x, x, q_positions=pos, kv_positions=pos, causal=True, window=None,
                     kv_chunk=2, schedule="tri")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        TC.ebv_attention_sharded(x, x, x, q_positions=pos, window=None)
