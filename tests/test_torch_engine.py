"""The port's serving engine (``repro_torch.serve.engine``) against the
reference's, on the CPU, at ``llama3_8b.reduced()`` in fp32 with the
reference's weights carried across (``convert.lm_params_from_numpy``).

* Greedy serving returns the reference's tokens, dense and paged, with the
  same dispatch counts and padding accounting.  The reference's paged
  engine reaches its Pallas kernel, which jax releases without ``pl.load``
  cannot run; the test swaps in its pure-jnp twin for the duration of the
  test (nothing in ``src/repro`` changes).
* Within the port, as the reference's own contract has it: a paged serve is
  bitwise equal to a dense serve, and a warm prefix-cache admission to a
  cold one (the plain B13 runs the dense decode's op sequence on the CPU).
* Sampled decoding draws from a per-request ``torch.Generator``, not from
  the reference's PRNG keys, so for it only the port's own contract is
  held: a request's tokens depend on its seed alone.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.kernels import paged_attn as ref_paged
from repro.models import lm as RL
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import GenRequest as RefRequest
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import Engine, GenRequest
from repro_torch.solvers import cache as solver_cache
from repro_torch.solvers.problem import Problem

LENS = [3, 9, 5, 12, 2, 7, 4, 10]
NEWS = [9, 2, 5, 3, 11, 4, 6, 2]


@pytest.fixture(scope="module")
def setup():
    rc = ref_config("llama3_8b").reduced()
    cfg = get_config("llama3_8b").reduced()
    params = RL.init_params(jax.random.PRNGKey(0), rc)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return rc, cfg, params, model


def prompts(seed=42, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (s,)).astype(np.int32) for s in lens]


def requests(kind=GenRequest, temperature=0.0, **kw):
    return [kind(t, n, temperature=temperature if i % 2 == 0 else 0.0, seed=100 + i, **kw)
            for i, (t, n) in enumerate(zip(prompts(), NEWS))]


def same(outs_a, outs_b):
    assert len(outs_a) == len(outs_b)
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


def stats_of(st):
    return (st.prefill_dispatches, st.decode_dispatches, st.generated_tokens, st.padding_frac,
            st.peak_active, st.events, st.shard_peak_cost)


def test_greedy_serve_equals_the_reference_dense_engine(setup):
    rc, cfg, params, model = setup
    ref = RefEngine(params, rc, max_len=64, slots=4, bucket=4)
    want = ref.serve(requests(RefRequest))
    eng = Engine(model, cfg, max_len=64, slots=4, bucket=4)
    got = eng.serve(requests())
    same(got, want)
    assert all(g.dtype == np.int32 for g in got)
    assert stats_of(eng.stats) == stats_of(ref.stats)
    assert eng.stats.tokens_per_dispatch == ref.stats.tokens_per_dispatch


def test_greedy_paged_serve_equals_the_reference_paged_engine(setup, monkeypatch):
    monkeypatch.setattr(ref_paged, "paged_decode_attention", ref_paged.paged_decode_attention_ref)
    rc, cfg, params, model = setup
    ref = RefEngine(params, rc, max_len=64, slots=4, bucket=4, paged=True, page_size=8)
    want = ref.serve(requests(RefRequest))
    eng = Engine(model, cfg, max_len=64, slots=4, bucket=4, paged=True, page_size=8)
    got = eng.serve(requests())
    same(got, want)
    assert stats_of(eng.stats) == stats_of(ref.stats)
    for name in ("pool_peak_pages", "page_frac", "prefix_hits", "prefix_hit_tokens"):
        assert getattr(eng.stats, name) == getattr(ref.stats, name), name
    assert eng.pool.free == ref.pool.free
    assert sorted(eng.prefix_cache.pages.values()) == sorted(ref.prefix_cache.pages.values())


def test_eos_truncation_equals_the_reference(setup):
    rc, cfg, params, model = setup
    prompt = prompts(7, [12])[0]
    dense = Engine(model, cfg, max_len=64, slots=2, bucket=4)
    base = dense.serve([GenRequest(prompt, 10, seed=1)])[0]
    gen = base[len(prompt):]
    # the first generated token after the first that has not come before
    k = next((k for k in range(1, len(gen)) if gen[k] not in gen[:k]), 0)
    eos_tok = int(gen[k])
    ref = RefEngine(params, rc, max_len=64, slots=2, bucket=4, eos_poll=2)
    want = ref.serve([RefRequest(prompt, 10, seed=1, eos_token=eos_tok),
                      RefRequest(prompts(8, [5])[0], 6, seed=2)])
    for paged in (False, True):
        kw = dict(paged=True, page_size=8) if paged else {}
        eng = Engine(model, cfg, max_len=64, slots=2, bucket=4, eos_poll=2, **kw)
        got = eng.serve([GenRequest(prompt, 10, seed=1, eos_token=eos_tok),
                         GenRequest(prompts(8, [5])[0], 6, seed=2)])
        same(got, want)
        np.testing.assert_array_equal(got[0], base[: len(prompt) + k + 1])  # ends AT the eos token
        assert eng.stats.early_exits == ref.stats.early_exits == 1
        assert eng.stats.decode_dispatches == ref.stats.decode_dispatches
        assert eng.stats.generated_tokens == ref.stats.generated_tokens


def test_paged_serve_is_bitwise_the_dense_serve(setup):
    _, cfg, _, model = setup
    dense = Engine(model, cfg, max_len=64, slots=4, bucket=4)
    paged = Engine(model, cfg, max_len=64, slots=4, bucket=4, paged=True, page_size=8)
    same(paged.serve(requests(temperature=0.8)), dense.serve(requests(temperature=0.8)))
    st, pool = paged.stats, paged.pool
    assert st.peak_active <= 4 and st.pool_peak_pages <= pool.capacity
    # every retired page came back; only the prefix index pins pages
    assert pool.free == pool.capacity - len(set(paged.prefix_cache.pages.values()))
    assert st.sched.page_tokens >= st.sched.live_tokens > 0
    assert st.page_frac == pytest.approx((st.sched.page_tokens - st.sched.live_tokens)
                                         / st.sched.page_tokens)


def test_warm_prefix_is_bitwise_the_cold_one(setup):
    _, cfg, _, model = setup
    prompt = prompts(7, [37])[0]
    eng = Engine(model, cfg, max_len=64, slots=2, bucket=8, paged=True, page_size=8)
    cold = eng.serve([GenRequest(prompt, 6, seed=1)])[0]
    assert eng.stats.prefix_hits == 0
    warm = eng.serve([GenRequest(prompt, 6, seed=1)])[0]
    np.testing.assert_array_equal(cold, warm)
    # the lookup stops strictly before the last prompt token: (37 - 1) // 8 =
    # 4 pages = 32 tokens reused, 5 suffix tokens prefilled again
    assert eng.stats.prefix_hits == 1 and eng.stats.prefix_hit_tokens == 32
    dense = Engine(model, cfg, max_len=64, slots=2, bucket=8)
    np.testing.assert_array_equal(dense.serve([GenRequest(prompt, 6, seed=1)])[0], warm)


def test_a_divergent_sharer_leaves_the_shared_pages_alone(setup):
    _, cfg, _, model = setup
    a = prompts(11, [37])[0]
    b = a.copy()
    b[20] = (b[20] + 1) % cfg.vocab_size  # diverges inside page 2 of 8
    dense = Engine(model, cfg, max_len=64, slots=2, bucket=8)
    want_a = dense.serve([GenRequest(a, 6, seed=1)])[0]
    want_b = dense.serve([GenRequest(b, 6, seed=2)])[0]
    eng = Engine(model, cfg, max_len=64, slots=2, bucket=8, paged=True, page_size=8)
    eng.serve([GenRequest(a, 6, seed=1)])  # the donor fills the prefix index
    outs = eng.serve([GenRequest(a, 6, seed=1), GenRequest(b, 6, seed=2)])
    np.testing.assert_array_equal(outs[0], want_a)
    np.testing.assert_array_equal(outs[1], want_b)
    for page in set(eng.prefix_cache.pages.values()):
        assert eng.pool.refcount(page) == 1  # only the index holds it now
    np.testing.assert_array_equal(eng.serve([GenRequest(a, 6, seed=1)])[0], want_a)


def test_pool_exhaustion_queues(setup):
    """5 requests of 3 pages each against a 6-page pool: at most 2 fit at
    once, the rest queue, and the tokens stay bitwise the dense serve's."""
    _, cfg, _, model = setup
    reqs = [GenRequest(p, 4, seed=10 + i) for i, p in enumerate(prompts(5, [20] * 5))]
    eng = Engine(model, cfg, max_len=64, slots=8, bucket=4, paged=True, page_size=8,
                 pool_pages=7, prefix_reuse=False)
    outs = eng.serve(reqs)
    assert eng.stats.peak_active <= 2 and eng.pool.failed_allocs > 0
    assert eng.pool.free == eng.pool.capacity
    same(outs, Engine(model, cfg, max_len=64, slots=8, bucket=4).serve(reqs))


def test_an_oversized_request_is_rejected_up_front(setup):
    _, cfg, _, model = setup
    eng = Engine(model, cfg, max_len=64, slots=2, bucket=4, paged=True, page_size=8, pool_pages=5)
    with pytest.raises(ValueError, match="pool only holds"):
        eng.serve([GenRequest(np.zeros((30,), np.int32), max_new_tokens=4)])
    with pytest.raises(ValueError, match="max_len"):
        eng.serve([GenRequest(np.zeros((60,), np.int32), max_new_tokens=8)])
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        eng.serve([GenRequest(np.zeros((4,), np.int32), max_new_tokens=0)])


def test_what_cannot_be_paged_or_sharded_is_refused(setup):
    _, cfg, _, model = setup
    for arch, err in [("mixtral_8x22b", "sliding-window"), ("mamba2_1_3b", "SSM"),
                      ("hymba_1_5b", "sliding-window")]:
        with pytest.raises(ValueError, match=err):
            Engine(None, get_config(arch).reduced(), max_len=64, paged=True, page_size=8)
    with pytest.raises(ValueError, match="multiple of bucket"):
        Engine(model, cfg, max_len=64, bucket=4, paged=True, page_size=6)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        Engine(model, cfg, slots=4, paged=True, page_size=8, shards=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        Engine(model, cfg, paged=True, page_size=8, mesh=object())


def test_sampled_tokens_depend_on_the_seed_alone(setup):
    _, cfg, _, model = setup
    reqs = requests(temperature=0.8)
    solo = [Engine(model, cfg, max_len=64, slots=1, bucket=4).serve([r])[0] for r in reqs[:3]]
    batched = Engine(model, cfg, max_len=64, slots=4, bucket=4).serve(reqs)
    same(batched[:3], solo)
    other = Engine(model, cfg, max_len=64, slots=4, bucket=4).serve(
        [GenRequest(r.tokens, r.max_new_tokens, temperature=0.8, seed=r.seed + 1000) for r in reqs])
    assert any(not np.array_equal(a, b) for a, b in zip(other[::2], batched[::2]))


def test_generate_is_one_slot_per_row(setup):
    _, cfg, _, model = setup
    p = np.stack(prompts(3, [6, 6, 6]))
    eng = Engine(model, cfg, max_len=32)
    out = eng.generate(p, max_new_tokens=5)
    assert out.shape == (3, 11) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:, :6], p)
    np.testing.assert_array_equal(out[1], eng.serve([GenRequest(p[1], 5, seed=1)])[0])


def test_the_default_page_size_comes_from_the_autotune_cache(setup, tmp_path, monkeypatch):
    _, cfg, _, model = setup
    monkeypatch.setenv(solver_cache.ENV_VAR, str(tmp_path / "cache.json"))
    solver_cache.invalidate()
    try:
        assert Engine(model, cfg, max_len=64, paged=True).page_size == 16  # no record
        c = solver_cache.get_cache()
        prob = Problem(op="decode", structure="paged_kv", n=64, dtype="float32",
                                    device="cpu")
        c.record_page_sizes(prob, {8: 120.0, 32: 95.5, 16: 130.0})
        c.save()
        solver_cache.invalidate()
        assert solver_cache.get_cache().best_page_size(prob) == 32
        assert Engine(model, cfg, max_len=64, paged=True).page_size == 32
        # a measurement on another device does not steer this one
        assert solver_cache.get_cache().best_page_size(
            Problem(op="decode", structure="paged_kv", n=64, device="NVIDIA H100")) is None

        def broken():
            raise OSError("cache unreadable")

        monkeypatch.setattr("repro_torch.serve.engine.get_cache", broken)
        with pytest.raises(OSError, match="unreadable"):  # no record means 16; an error propagates
            Engine(model, cfg, max_len=64, paged=True)
    finally:
        solver_cache.invalidate()


@pytest.mark.parametrize("paged", [False, True])
def test_the_launcher_serves_on_the_cpu(paged, capsys):
    argv = ["--device", "cpu", "--arch", "llama3_8b", "--reduced", "--batch", "3", "--ragged"]
    launch_serve.main(argv + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "dispatches: 3 prefill + " in out
    assert ("page pool: peak" in out) is paged and ("prefix reuse:" in out) is paged
    with pytest.raises(SystemExit):
        launch_serve.main(argv + ["--paged", "--shards", "2"])
