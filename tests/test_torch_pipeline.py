"""The port's token pipeline (``repro_torch.data.pipeline``) against the
reference's, on the CPU: both are numpy, so every batch is held bit for
bit — the Philox source, a uint16 token memmap (with its wrap), two data
shards, ``state()`` / ``restore()`` and the prefetch thread."""
import numpy as np
import pytest

from repro.data.pipeline import TokenPipeline as RefPipeline
from repro_torch.data import TokenPipeline


def batches(pipe, n):
    return [next(pipe) for _ in range(n)]


def same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        assert g["tokens"].dtype == w["tokens"].dtype == np.int32
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 65535, 5000).astype(np.uint16).tofile(path)
    return str(path)


@pytest.mark.parametrize("seed,vocab", [(0, 256), (7, 128256), (123, 50)])
def test_philox_batches_equal_the_references(seed, vocab):
    kw = dict(vocab_size=vocab, seq_len=17, global_batch=6, seed=seed)
    same(batches(TokenPipeline(**kw), 5), batches(RefPipeline(**kw), 5))


@pytest.mark.parametrize("seq_len,batch", [(16, 4), (100, 8), (1000, 5), (1000, 6)])
def test_memmap_batches_equal_the_references_and_wrap(token_file, seq_len, batch):
    # 5000 tokens: (1000, 5) takes the whole file a step, (1000, 6) wraps
    kw = dict(vocab_size=300, seq_len=seq_len, global_batch=batch, token_file=token_file)
    got = batches(TokenPipeline(**kw), 9)
    same(got, batches(RefPipeline(**kw), 9))
    assert all(int(b["tokens"].max()) < 300 for b in got)


@pytest.mark.parametrize("token", [False, True])
def test_two_shards_equal_the_references_and_split_the_global_batch(token_file, token):
    kw = dict(vocab_size=1000, seq_len=12, global_batch=8, num_shards=2, seed=3,
              token_file=token_file if token else None)
    shards = []
    for shard in (0, 1):
        got = batches(TokenPipeline(shard_index=shard, **kw), 4)
        same(got, batches(RefPipeline(shard_index=shard, **kw), 4))
        assert got[0]["tokens"].shape == (4, 12)
        shards.append(got)
    assert not np.array_equal(shards[0][0]["tokens"], shards[1][0]["tokens"])
    if token:  # the shards are the global batch's two halves
        whole = batches(TokenPipeline(**dict(kw, num_shards=1)), 4)
        for step in range(4):
            np.testing.assert_array_equal(
                np.concatenate([shards[0][step]["tokens"], shards[1][step]["tokens"]]),
                whole[step]["tokens"])


def test_a_global_batch_that_does_not_split_is_refused():
    with pytest.raises(ValueError):
        TokenPipeline(vocab_size=10, seq_len=4, global_batch=5, num_shards=2)


@pytest.mark.parametrize("token", [False, True])
def test_restore_replays_the_stream_from_a_saved_state(token_file, token):
    kw = dict(vocab_size=500, seq_len=9, global_batch=3, seed=11,
              token_file=token_file if token else None)
    pipe = TokenPipeline(**kw)
    batches(pipe, 3)
    state = pipe.state()
    assert state == {"step": 3, "seed": 11}
    rest = batches(pipe, 4)
    again = TokenPipeline(**dict(kw, seed=0)).restore(state)
    same(batches(again, 4), rest)
    ref = RefPipeline(**dict(kw, seed=0)).restore(state)
    same(rest, batches(ref, 4))
    same(batches(TokenPipeline(**dict(kw, start_step=3)), 4), rest)


def test_the_prefetch_thread_yields_the_synchronous_stream():
    kw = dict(vocab_size=256, seq_len=32, global_batch=4, seed=5, prefetch_depth=3)
    want = batches(TokenPipeline(**kw), 6)
    pipe = TokenPipeline(**kw).start()
    assert pipe.start() is pipe  # a second start keeps the one thread
    try:
        same(batches(pipe, 6), want)
        assert pipe.state()["step"] == 6
    finally:
        pipe.stop()
    assert pipe._thread is None and pipe._queue.empty()
    # restore stops the thread; the stream goes on from the restored step
    pipe.start()
    batches(pipe, 2)
    pipe.restore({"step": 2, "seed": 5})
    assert pipe._thread is None
    same(batches(pipe, 4), want[2:])
    ref = RefPipeline(**kw).start()
    try:
        same(batches(ref, 6), want)
    finally:
        ref.stop()
