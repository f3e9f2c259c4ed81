"""Kill-and-recover tests of the port's engine, on the CPU.

``tests/test_serve_recover.py`` against the torch engine: each scenario
serves in a SUBPROCESS (``device="cpu"``, the stablelm smoke config in fp32
compute, a journal through ``recover()``), kills it mid-stream, either
with the ``crash_at`` fault site (``os._exit(137)`` at the third chunk
read-back) or with a real SIGKILL from outside, then starts a fresh process
on the same state directory that recovers. Every request the dead process
accepted is either finished before the kill (its output printed, or its
``finish`` record in the journal) or replayed with the tokens of an
uncrashed run. Each incarnation is ``python -m
repro_torch.launch.incarnation``, which ``chip_smoke.py`` runs on the card.
The synchronous and the async engine both pass; they share one oracle,
since their tokens are equal (``tests/test_torch_serve_async.py``).
"""
import os
import re
import signal
import subprocess
import sys
import time

import pytest

ENV = {**os.environ,
       "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src")}


def _cmd(state_dir, *, faults=None, submit=True, async_decode=False):
    """One incarnation (``repro_torch.launch.incarnation``, the smoke config
    on the CPU) on ``state_dir``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.incarnation",
           "--state-dir", str(state_dir), "--device", "cpu"]
    if faults:
        cmd += ["--fault-inject", faults]
    if not submit:
        cmd.append("--no-submit")
    if async_decode:
        cmd.append("--async")
    return cmd


def _run_sub(cmd, timeout=300.0):
    return subprocess.run(cmd, env=ENV, capture_output=True, text=True,
                          timeout=timeout)


def _parse(stdout):
    """stdout -> ({id: tokens} finished, {old_id: tokens} replayed)."""
    done, replayed = {}, {}
    for line in stdout.strip().splitlines():
        parts = line.split()
        if parts and parts[0] == "DONE":
            done[int(parts[1])] = parts[2]
        elif parts and parts[0] == "REPLAYED":
            replayed[int(parts[1])] = parts[2]
    return done, replayed


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Tokens per request id from one clean, uncrashed run."""
    state = tmp_path_factory.mktemp("oracle-state")
    r = _run_sub(_cmd(state))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "EXIT CLEAN"
    done, _ = _parse(r.stdout)
    assert sorted(done) == [0, 1, 2, 3]
    return done


def _journal_finished_ids(path):
    """Ids with a ``finish`` record (compact sorted-key JSON puts
    ``"id":N,"k":"finish"`` side by side)."""
    try:
        blob = open(path, "rb").read()
    except OSError:
        return set()
    return {int(m) for m in re.findall(rb'"id":(\d+),"k":"finish"', blob)}


def _assert_recovered(oracle, crashed_out, recovered_out,
                      journal_finished=()):
    """Every accepted request finished before the kill or replayed with the
    oracle's tokens; none lost, none answered twice."""
    crash_done, _ = _parse(crashed_out)
    rec_done, rec_replayed = _parse(recovered_out)
    assert not rec_done                         # the recovery submits none
    for rid, want in oracle.items():
        got = crash_done.get(rid) or rec_replayed.get(rid)
        if got is None:
            assert rid in journal_finished, \
                f"request {rid} lost: neither finished nor replayed"
            continue
        assert got == want, f"request {rid} tokens diverged after recovery"
    assert not (set(crash_done) & set(rec_replayed))


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync", "async"])
def test_crash_at_then_recover(oracle, tmp_path, async_decode):
    state = tmp_path / "state"
    crash = _run_sub(_cmd(state, faults="crash_at:at=3",
                          async_decode=async_decode))
    assert crash.returncode == 137, \
        f"rc={crash.returncode}\n{crash.stderr[-3000:]}"
    assert os.path.exists(os.path.join(str(state), "journal.wal"))
    rec = _run_sub(_cmd(state, submit=False, async_decode=async_decode))
    assert rec.returncode == 0, rec.stderr[-3000:]
    assert rec.stdout.strip().splitlines()[-1] == "EXIT CLEAN"
    _, replayed = _parse(rec.stdout)
    assert replayed                             # the kill left work behind
    _assert_recovered(oracle, crash.stdout, rec.stdout)
    assert os.path.exists(os.path.join(str(state), "journal.wal.replayed"))


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync", "async"])
def test_sigkill_then_recover(oracle, tmp_path, async_decode):
    state = tmp_path / "state"
    jpath = os.path.join(str(state), "journal.wal")
    proc = subprocess.Popen(_cmd(state, async_decode=async_decode),
                            env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    # kill once the journal holds all 4 submits and a first token, so the
    # kill lands mid-stream
    deadline = time.monotonic() + 300.0
    try:
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break                           # outran the poll
            try:
                blob = open(jpath, "rb").read()
            except OSError:
                blob = b""
            if blob.count(b'"k":"submit"') >= 4 \
                    and blob.count(b'"k":"first_token"') >= 1:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.005)
        out, err = proc.communicate(timeout=300.0)
    finally:
        proc.kill()
    assert os.path.exists(jpath), err[-3000:]
    rec = _run_sub(_cmd(state, submit=False, async_decode=async_decode))
    assert rec.returncode == 0, rec.stderr[-3000:]
    assert rec.stdout.strip().splitlines()[-1] == "EXIT CLEAN"
    finished = _journal_finished_ids(jpath + ".replayed")
    _assert_recovered(oracle, out, rec.stdout, journal_finished=finished)
