"""Window arithmetic and work counts against hand-worked values."""
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import roofline
from perfbench.harness import load_module

BENCH = Path(__file__).resolve().parents[1]


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py")


def conf(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def req(phase, due, first, finish, n, ok=True, admitted=None, plen=10):
    return SimpleNamespace(
        phase=phase, due=due, first=first, finish=finish, ok=ok,
        error=None if ok else "failed", late=False,
        admitted=admitted, prompt_len=plen,
        n_out=n if ok else 0, tokens=np.zeros(n) if ok else None)


def serve_run(reqs, window=(10.0, 20.0)):
    return SimpleNamespace(requests=reqs, steps=None, window=window,
                           profile=None, obs=None)


def test_output_rate_counts_tokens_emitted_inside_the_window():
    # 11 tokens evenly from 8 to 18 (one a second): 9..18 fall in
    # [10, 20) except 8 and 9 -> 9 tokens; a second request's 5 tokens
    # at 19, 20, 21, 22, 23 -> 1
    r = serve_run([req("ramp", 7, 8.0, 18.0, 11),
                   req("window", 18, 19.0, 23.0, 5)])
    assert metric("output_tok_s").read(r) == pytest.approx(10 / 10.0)


def test_ttft_tail_counts_misses():
    reqs = [req("window", 10 + i, 10 + i + 0.1 * (i + 1), 40, 3)
            for i in range(20)]
    r = serve_run(reqs)
    # nearest rank 95% of 20 = the 19th smallest: 1.9 s
    assert metric("ttft_p95_s").read(r) == pytest.approx(1.9)
    reqs[0] = req("window", 10, None, None, 0, ok=False)
    # one miss: the 19th smallest of 19 finite + inf is now 2.0
    assert metric("ttft_p95_s").read(serve_run(reqs)) == pytest.approx(2.0)
    reqs[1] = req("window", 11, None, None, 0, ok=False)
    assert metric("ttft_p95_s").read(serve_run(reqs)) is None
    # ramp requests are not the window's
    reqs = [req("ramp", 0, 50.0, 60.0, 3)] + reqs[2:]
    assert metric("ttft_p95_s").read(serve_run(reqs)) == pytest.approx(2.0)
    # late, not failed: its first token counts, its finish is a miss
    late = req("window", 10, 10.5, None, 0, ok=False)
    late.error, late.late = None, True
    reqs = [late] + [req("window", 10 + i, 10 + i + 0.1 * (i + 1), 40, 3)
                     for i in range(19)]
    assert metric("ttft_p95_s").read(serve_run(reqs)) == pytest.approx(1.8)


def test_tpot_tail():
    reqs = [req("window", 10, 11.0, 11.0 + 0.01 * (i + 1) * 9, 10)
            for i in range(20)]
    assert metric("tpot_p95_ms").read(serve_run(reqs)) == \
        pytest.approx(190.0)


def test_train_rate_is_all_steps_over_all_time():
    r = SimpleNamespace(steps={"n": 7, "wall_s": 35.0, "tokens": 16384})
    assert metric("train_tok_s").read(r) == pytest.approx(7 * 16384 / 35.0)
    assert metric("output_tok_s").read(
        SimpleNamespace(steps=r.steps, requests=[])) is None


def test_mfu_train_palm_count_stablelm():
    c = conf("stablelm-1.6b")
    spec = SimpleNamespace(reference=lambda: load_module(
        BENCH / "reference" / "dense.py"))
    # the window's 8 untraced steps in 40 s; the traced step's slower
    # wall time does not enter
    r = SimpleNamespace(spec=spec, conf=c, mix={"seq_len": 2048},
                        steps={"tokens": 16384, "n": 8, "wall_s": 40.0,
                               "traced": {"n": 1, "wall_s": 6.0}})
    D, F, V, L = 2048, 5632, 100352, 24
    N = L * (4 * D * D + 3 * D * F) + D * V
    flops = (6 * N + 12 * L * D * 2048) * 16384
    assert metric("mfu.train").read(r) == pytest.approx(
        100 * flops / 5.0 / 989e12)
    assert 1.0 < metric("mfu.train").read(r) < 10.0


def test_idle_share_train_uses_the_untraced_step_time():
    # busy 4.5 s in one traced step (its own wall 6.0 s); the window's
    # steps took 5.0 s each: idle 10%, not 25%
    prof = SimpleNamespace(busy_s=lambda: 4.5, window_s=6.0)
    r = SimpleNamespace(profile=prof,
                        steps={"n": 8, "wall_s": 40.0,
                               "traced": {"n": 1, "wall_s": 6.0}})
    assert metric("idle_share.train").read(r) == pytest.approx(10.0)
    r.profile = None
    assert metric("idle_share.train").read(r) is None


def test_least_time_takes_the_largest_term():
    t, which = roofline.least_time(nbytes=3.35e12, bf16_flops=989e12 / 2)
    assert (t, which) == (pytest.approx(1.0), "bytes")
    t, which = roofline.least_time(nbytes=1.0, exps=4.18e12 * 2)
    assert (t, which) == (pytest.approx(2.0), "exponentials")


class FakeProfile:
    def __init__(self, seconds, launches=1, t0=0.0, t1=100.0):
        self.seconds, self.launches, self.t0, self.t1 = \
            seconds, launches, t0, t1

    def kernel_s(self, kernels):
        return self.seconds, self.launches


def test_k1_work_is_the_keys_each_decoded_token_reads():
    c = conf("stablelm-1.6b")
    spec = SimpleNamespace(reference=lambda: load_module(
        BENCH / "reference" / "dense.py"))
    # one answer of 3 tokens after a 100-token prompt: tokens 2 and 3
    # decode, reading 101 and 102 keys
    q = req("window", 0, 1.0, 2.0, 3, plen=100)
    r = SimpleNamespace(spec=spec, conf=c, steps=None, requests=[q],
                        profile=FakeProfile(1e-3), notes=[])
    keys = 203
    nbytes = 24 * (keys * 2 * 32 * 64 * 2 + 2 * 2 * 32 * 64 * 2)
    want = 100 * (nbytes / 3.35e12) / 1e-3
    assert metric("k1_roofline.serve").read(r) == pytest.approx(want)
    r.profile = FakeProfile(0.0, launches=0)
    assert metric("k1_roofline.serve").read(r) is None


def test_k3bwd_work_hand_count():
    c = conf("falcon-mamba-7b-16l")
    spec = SimpleNamespace(reference=lambda: load_module(
        BENCH / "reference" / "mamba1.py"))
    r = SimpleNamespace(spec=spec, conf=c, notes=[],
                        steps={"tokens": 2048, "traced": {"n": 1,
                                                          "wall_s": 1.0}},
                        profile=FakeProfile(1e-3))
    T, dI, N = 2048, 8192, 16
    nbytes = 16 * (T * dI * 16 + T * 4 * N * 2)
    least = max(nbytes / 3.35e12, 16 * T * dI * N / 4.18e12,
                16 * 16 * T * dI * N / 67e12)
    assert metric("k3bwd_roofline.train").read(r) == \
        pytest.approx(100 * least / 1e-3)
    assert math.isclose(least, nbytes / 3.35e12)
