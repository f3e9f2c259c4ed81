"""The traffic generators: the same seed gives the same requests, every
seed the same work in another order, lengths within the mix's clips."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.harness import load_module

BENCH = Path(__file__).resolve().parents[1]
CHAT = json.loads((BENCH / "traffic" / "chat.json").read_text())
TRAIN = json.loads((BENCH / "traffic" / "train-2k.json").read_text())
gen = load_module(BENCH / "traffic" / "open_loop.py")
batches = load_module(BENCH / "traffic" / "lm_batches.py")
CELL = {"rate_per_s": 1.5, "ramp_s": 20}


def _reqs(seed, seconds=40):
    return gen.requests(CHAT, CELL, 100352, seed, seconds)


def test_same_seed_same_requests():
    a, b = _reqs(2 ** 31 + 11), _reqs(2 ** 31 + 11)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["due"] == y["due"] and x["max_new"] == y["max_new"]
        assert np.array_equal(x["prompt"], y["prompt"])


def test_seeds_share_the_work_in_another_order():
    a, b = _reqs(3), _reqs(2 ** 32 + 5)
    for phase in ("ramp", "window", "after"):
        pa = [q for q in a if q["phase"] == phase]
        pb = [q for q in b if q["phase"] == phase]
        assert sorted(len(q["prompt"]) for q in pa) == \
            sorted(len(q["prompt"]) for q in pb)
        assert sorted(q["max_new"] for q in pa) == \
            sorted(q["max_new"] for q in pb)
        assert [len(q["prompt"]) for q in pa] != \
            [len(q["prompt"]) for q in pb]


@pytest.mark.parametrize("key", ["prompt", "max_new", "gap"])
def test_each_block_takes_one_value_from_every_stratum(key):
    # a window of 60 requests: 7 full blocks of 8 and a last one of 4;
    # the j-th smallest value of a full block lies in the j-th stratum of
    # the window's sorted values, so each stretch of blocks is offered
    # about the same work whatever the seed
    m = CHAT["block"]
    for seed in (1, 2 ** 31 + 7, 2 ** 32 + 9):
        win = [q for q in _reqs(seed) if q["phase"] == "window"]
        dues = [CELL["ramp_s"]] + [q["due"] for q in win]
        vals = {"prompt": [len(q["prompt"]) for q in win],
                "max_new": [q["max_new"] for q in win],
                "gap": list(np.diff(dues))}[key]
        strata = np.array_split(np.sort(vals), m)
        assert len(vals) // m == 7
        for b in range(len(vals) // m):
            got = sorted(vals[b * m:(b + 1) * m])
            for v, st in zip(got, strata):
                assert st[0] - 1e-9 <= v <= st[-1] + 1e-9


@pytest.mark.parametrize("seconds", [10, 40, 51])
def test_window_count_and_span(seconds):
    reqs = _reqs(7, seconds)
    win = [q for q in reqs if q["phase"] == "window"]
    assert len(win) == round(CELL["rate_per_s"] * seconds)
    ramp = CELL["ramp_s"]
    dues = [q["due"] for q in win]
    assert min(dues) >= ramp and max(dues) == pytest.approx(ramp + seconds)
    assert dues == sorted(dues)


def test_lengths_within_clips_and_median():
    reqs = _reqs(9)
    p = np.array([len(q["prompt"]) for q in reqs])
    o = np.array([q["max_new"] for q in reqs])
    assert p.min() >= CHAT["prompt_len"]["min"]
    assert p.max() <= CHAT["prompt_len"]["max"]
    assert o.min() >= CHAT["output_len"]["min"]
    assert o.max() <= CHAT["output_len"]["max"]
    assert (p + o).max() <= 4096
    win = [len(q["prompt"]) for q in reqs if q["phase"] == "window"]
    assert abs(np.median(win) - CHAT["prompt_len"]["median"]) < 60


def test_token_ids_cover_the_vocabulary():
    ids = np.concatenate([q["prompt"] for q in _reqs(5)])
    assert ids.min() >= 0 and ids.max() < 100352
    assert ids.max() > 90000          # not the old 0..500 range


def test_training_batches():
    a = batches.batch(TRAIN, 65024, 2 ** 31 + 3, 4)
    b = batches.batch(TRAIN, 65024, 2 ** 31 + 3, 4)
    c = batches.batch(TRAIN, 65024, 2 ** 31 + 3, 5)
    assert a.shape == (TRAIN["batch"], TRAIN["seq_len"])
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert len({r.tobytes() for r in np.concatenate([a, c])}) == 2 * len(a)
