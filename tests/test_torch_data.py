"""The port's synthetic data pipeline (repro_torch.data.pipeline) gives
the JAX package's batches bit for bit: several seeds and steps, the two
ranks of a two-process job, the embedding frontend's (B, S, M) fp32
inputs, and the prefetching iterator's stream, from step 0 and after a
restart at a later step."""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jdata  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402


def _both(pidx, pcount, **kw):
    return (jdata.SyntheticTokenPipeline(jdata.DataConfig(**kw), pidx, pcount),
            tdata.SyntheticTokenPipeline(tdata.DataConfig(**kw), pidx, pcount))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("pidx,pcount", [(0, 1), (0, 2), (1, 2)],
                         ids=["single", "rank0of2", "rank1of2"])
def test_batch_at_is_bit_identical(seed, pidx, pcount):
    jp, tp = _both(pidx, pcount, global_batch=4, seq_len=32, vocab_size=512,
                   seed=seed)
    assert tp.local_batch == jp.local_batch == 4 // pcount
    for step in (0, 3, 100):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert set(got) == set(want) == {"inputs", "labels"}
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_restarted_iterator_resumes_the_stream():
    """start(k) resumes at step k: the batches JAX gives for k, k+1, ..."""
    jp, tp = _both(1, 2, global_batch=4, seq_len=8, vocab_size=64, seed=3)
    tp.start(5)
    try:
        for step, batch in zip(range(5, 8), iter(tp)):
            for key in ("inputs", "labels"):
                np.testing.assert_array_equal(batch[key],
                                              jp.batch_at(step)[key])
    finally:
        tp.stop()
    assert tp._step == 8


def test_prefetching_iterator_yields_the_same_stream():
    jp, tp = _both(0, 1, global_batch=2, seq_len=16, vocab_size=128, seed=2)
    try:
        for step, batch in enumerate(itertools.islice(iter(tp), 4)):
            np.testing.assert_array_equal(batch["labels"],
                                          jp.batch_at(step)["labels"])
    finally:
        tp.stop()
    assert tp._thread is None


def test_process_index_defaults_without_torch_distributed():
    tp = tdata.SyntheticTokenPipeline(tdata.DataConfig(4, 8, 32))
    assert (tp.pidx, tp.pcount, tp.local_batch) == (0, 1, 4)
    with pytest.raises(ValueError):
        tdata.SyntheticTokenPipeline(tdata.DataConfig(3, 8, 32), 0, 2)


@pytest.mark.parametrize("embed_dim", [16, 64])
@pytest.mark.parametrize("pidx,pcount", [(0, 1), (1, 2)],
                         ids=["single", "rank1of2"])
def test_embedding_batches_are_bit_identical(embed_dim, pidx, pcount):
    """embed_dim > 0: standard-normal (local batch, S, M) fp32 inputs drawn
    after the labels from the same generator, and the same labels as
    without them."""
    jp, tp = _both(pidx, pcount, global_batch=4, seq_len=32, vocab_size=512,
                   seed=3, embed_dim=embed_dim)
    tokens = tdata.SyntheticTokenPipeline(
        tdata.DataConfig(4, 32, 512, seed=3), pidx, pcount)
    for step in (0, 5):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert got["inputs"].shape == (4 // pcount, 32, embed_dim)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        assert got["inputs"].dtype == np.float32
        np.testing.assert_array_equal(got["labels"],
                                      tokens.batch_at(step)["labels"])
