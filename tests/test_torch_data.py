"""The port's copy of the data pipeline against ``repro.data.pipeline``:
``SyntheticLM.batch_at`` gives the reference's arrays bit for bit, and the
port's ``Prefetcher`` keeps the reference's contract (steps in order, never
blocking when full) in both drive modes."""
import numpy as np
import pytest

from repro.data import pipeline as jdata
from repro_torch.core import Executor
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_batches_bit_equal_to_reference(seed):
    kw = dict(vocab_size=503, seq_len=33, global_batch=4, seed=seed)
    ours, ref = SyntheticLM(DataConfig(**kw)), \
        jdata.SyntheticLM(jdata.DataConfig(**kw))
    np.testing.assert_array_equal(ours._next, ref._next)
    for step in (0, 1, 2, 7, 1000):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_frontend_embeds_bit_equal_to_reference():
    kw = dict(vocab_size=10, seq_len=8, global_batch=2, seed=1,
              frontend_tokens=4, d_model=16)
    a = SyntheticLM(DataConfig(**kw)).batch_at(3)
    b = jdata.SyntheticLM(jdata.DataConfig(**kw)).batch_at(3)
    assert a["frontend_embeds"].shape == (2, 4, 16)
    np.testing.assert_array_equal(a["frontend_embeds"], b["frontend_embeds"])


def test_prefetcher_nonblocking_when_full():
    src = SyntheticLM(DataConfig(vocab_size=10, seq_len=4, global_batch=1))
    p = Prefetcher(src.batch_at, depth=2)
    assert p.produce_one() and p.produce_one()
    assert p.produce_one() is False          # full -> skip, never block
    step, batch = p.get()
    assert step == 0
    np.testing.assert_array_equal(batch["tokens"], src.batch_at(0)["tokens"])
    assert p.produce_one()                   # space again
    p.stop()
    assert p.produce_one() is False


def test_prefetcher_on_executor_yields_steps_in_order():
    src = SyntheticLM(DataConfig(vocab_size=50, seq_len=8, global_batch=2,
                                 seed=5))
    with Executor(domains={"host": 3}) as ex:
        p = Prefetcher(src.batch_at, depth=3, start_step=4, executor=ex)
        p.start()
        for want in range(4, 14):
            step, batch = p.get(timeout=30)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(want)["tokens"])
            assert p.qsize() <= 3
        p.stop()
