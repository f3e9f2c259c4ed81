"""The port's benchmark suite (``repro_torch.bench``) against the JAX
package's (``benchmarks/``), on the CPU.

The host suites (table2, fig9, fig11, fig21) run on both packages at tiny
sizes: the port's rows carry every one of the reference's row names (the
port adds ``*/host_cores``). fig17's host rows keep their names and shape
(constant for the cyclic graph, growing with k unrolled). The harness
writes ``BENCH_<suite>.json`` with the keys of the reference's
``benchmarks/run.py:_write_trajectory``. The serve suite's rows carry the
reference's continuous and prefix-share row names (its per-call rows are
not ported; the port adds the cycle split), read from the port's registry,
and its trace file loads as Chrome trace-event JSON; so do the SLO
suite's (``serve_slo``), whose quick run must shed or expire. Timings are
host-clock numbers of this machine and are not compared.
"""
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import (fig9_micro_random_dag, fig11_corun_throughput,
                               fig17_conditional_memory,
                               fig21_incremental_timing, obs_overhead_gate,
                               paged_decode_microbench, pipeline_throughput,
                               serve_continuous)
from repro_torch.bench import run as trun
from repro_torch.bench import table2_task_overhead

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the reference's benchmarks package
    sys.path.insert(0, str(ROOT))

from benchmarks import fig9_micro_random_dag as jfig9  # noqa: E402
from benchmarks import fig11_corun_throughput as jfig11  # noqa: E402
from benchmarks import fig21_incremental_timing as jfig21  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from benchmarks import table2_task_overhead as jtable2  # noqa: E402

HOST_SUITES = {
    "table2": (jtable2.bench, table2_task_overhead.bench, {"n_ops": 2_000}),
    "fig9": (jfig9.bench, fig9_micro_random_dag.bench,
             {"sizes": (200,), "workers": 2}),
    "fig11": (jfig11.bench, fig11_corun_throughput.bench,
              {"n_tasks": 200, "coruns": (1, 2)}),
    "fig21": (jfig21.bench, fig21_incremental_timing.bench,
              {"n_gates": 200, "iters": 2}),
}


def _names(rows):
    return [r[0] for r in rows]


@pytest.mark.parametrize("suite", sorted(HOST_SUITES))
def test_host_suite_rows_carry_the_reference_names(suite):
    ref_bench, port_bench, kw = HOST_SUITES[suite]
    want = _names(ref_bench(**kw))
    rows = port_bench(**kw)
    got = _names(rows)
    assert [n for n in got if n in want] == want
    assert all(isinstance(v, (int, float)) for _, v, _ in rows)
    extra = set(got) - set(want)
    assert extra <= {f"{suite}/host_cores"}, extra


def test_fig17_host_rows():
    rows = fig17_conditional_memory.bench(iters=(8, 64), device="cpu")
    val = dict((n, v) for n, v, _ in rows)
    assert sorted(val) == sorted(
        f"fig17/host/{f}_k{k}_{m}" for k in (8, 64)
        for f in ("cyclic", "unrolled") for m in ("tasks", "bytes"))
    assert val["fig17/host/cyclic_k8_tasks"] == \
        val["fig17/host/cyclic_k64_tasks"] == 3
    assert val["fig17/host/cyclic_k8_bytes"] == \
        val["fig17/host/cyclic_k64_bytes"]
    assert (val["fig17/host/unrolled_k8_tasks"],
            val["fig17/host/unrolled_k64_tasks"]) == (8, 64)
    assert val["fig17/host/unrolled_k64_bytes"] > \
        val["fig17/host/unrolled_k8_bytes"]


def test_run_writes_the_reference_trajectory_schema(tmp_path):
    rc = trun.main(["--device", "cpu", "--quick", "--only", "table2,fig21",
                    "--bench-dir", str(tmp_path)])
    assert rc == 0
    ref = json.loads(Path(jrun._write_trajectory(
        str(tmp_path / "ref"), "table2", {}, [("a", 1.0, "")], 0.1))
        .read_text())
    for suite in ("table2", "fig21"):
        data = json.loads((tmp_path / f"BENCH_{suite}.json").read_text())
        assert set(data) == set(ref)
        assert data["suite"] == suite
        assert data["config"]["device"] == "cpu"
        assert data["config"]["quick"] is True
        assert set(data["rows"][0]) == {"name", "value", "derived"}
    names = [r["name"] for r in json.loads(
        (tmp_path / "BENCH_table2.json").read_text())["rows"]]
    assert names == _names(jtable2.bench(2_000))


def test_run_refuses_unported_and_unknown_suites():
    with pytest.raises(SystemExit, match="item 7"):
        trun.main(["--device", "cpu", "--only", "journal_gate"])
    with pytest.raises(SystemExit, match="unknown suite"):
        trun.main(["--device", "cpu", "--only", "fig99"])


def test_run_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--only", "table2"])


def test_paged_decode_rows_on_cpu():
    rows = list(paged_decode_microbench.bench(quick=True, device="cpu"))
    names = _names(rows)
    assert names == [f"{p}_read_{o}_occ_ms" for o in ("low", "mid", "full")
                     for p in ("paged", "plain", "gather")] + [
        "decode_step_paged_low_occ_ms", "decode_step_gather_low_occ_ms",
        "paged_read_kernel_launches"]
    assert all(float(v) > 0 for _, v, _ in rows[:-1])


def test_pipeline_rows_carry_the_reference_names():
    names = _names(pipeline_throughput.bench(quick=True, device="cpu"))
    assert names == [
        "pipeline_micro_loop_tok_per_s", "pipeline_micro_L1S4_tok_per_s",
        "pipeline_micro_L4S4_tok_per_s", "prefetch_manual_batch_per_s",
        "prefetch_pipeline_batch_per_s", "serve_loop_tok_per_s",
        "serve_pipeline_tok_per_s"]


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "saxpy ok on cpu: True" in out
    assert out.rstrip().endswith("quickstart complete")


def _reference_serve_rows(func: str):
    """The row names a function of ``benchmarks/serve_continuous.py``
    yields, read from its source (running it would compile the JAX
    engine)."""
    src = (ROOT / "benchmarks" / "serve_continuous.py").read_text()
    body = src.split(f"def {func}(")[1].split("\ndef ")[0]
    return re.findall(r'yield \(\s*"([a-z0-9_]+)"', body)


def test_serve_rows_carry_the_reference_names(tmp_path):
    trace = tmp_path / "t.json"
    rows = list(serve_continuous.bench(quick=True, device="cpu",
                                       trace_path=str(trace)))
    got = _names(rows)
    want = [n for n in _reference_serve_rows("bench")
            if not n.startswith("serve_percall")]
    assert [n for n in got if n in want] == want
    assert set(got) - set(want) == {"serve_cycle_mean_ms"}
    val = {n: v for n, v, _ in rows}
    der = {n: d for n, _, d in rows}
    assert float(val["serve_continuous_tok_per_s"]) > 0
    assert der["serve_ttft_p50_ms"] == "count_8"
    assert val["serve_continuous_paged_impl"] == "loop"
    payload = json.loads(trace.read_text())
    assert payload["otherData"]["spans"] == int(val["serve_trace_spans"])
    assert payload["otherData"]["metrics"]["serve.ttft_s"]["count"] == 8


def test_serve_prefix_share_rows_on_cpu():
    rows = list(serve_continuous.bench_prefix_share(quick=True,
                                                    device="cpu"))
    assert _names(rows) == _reference_serve_rows("bench_prefix_share")
    val = {n: v for n, v, _ in rows}
    der = {n: d for n, _, d in rows}
    assert float(val["serve_prefix_hit_rate"]) > 0
    assert int(val["serve_prefix_tokens_saved"]) > 0
    assert der["serve_prefix_workload"] == "loop"


def test_run_serves_prefix_share_and_the_obs_gate(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(obs_overhead_gate, "measure", lambda quick, dev: (
        calls.append((quick, str(dev))) or
        {"off": 100.0, "on": 99.5, "ratio": 0.995, "reps": 5}))
    rc = trun.main(["--device", "cpu", "--quick", "--only",
                    "serve,obs_gate", "--prefix-share",
                    "--bench-dir", str(tmp_path)])
    assert rc == 0 and calls == [(True, "cpu")]
    serve = json.loads((tmp_path / "BENCH_serve.json").read_text())
    assert serve["config"]["prefix_share"] is True
    assert serve["rows"][0]["name"] == "serve_prefix_hit_rate"
    assert (tmp_path / "TRACE_serve.json").exists()
    gate = json.loads((tmp_path / "BENCH_obs_gate.json").read_text())
    assert [r["name"] for r in gate["rows"]] == [
        "obs_gate_off_tok_per_s", "obs_gate_on_tok_per_s",
        "obs_gate_overhead_frac", "obs_gate"]


def test_serve_slo_rows_carry_the_reference_names(tmp_path):
    """The SLO suite through the harness at quick size: the reference's
    row names in its order (read from ``benchmarks/serve_slo.py``'s
    source; the tier-1 TTFT row only when a tier-1 request got a first
    token, as there), the overload controls engaged, its trace beside the
    BENCH file."""
    rc = trun.main(["--device", "cpu", "--quick", "--only", "serve_slo",
                    "--bench-dir", str(tmp_path)])
    assert rc == 0
    src = (ROOT / "benchmarks" / "serve_slo.py").read_text()
    want = re.findall(r'yield \(\s*"([a-z0-9_]+)"', src)
    got = json.loads((tmp_path / "BENCH_serve_slo.json").read_text())
    names = [r["name"] for r in got["rows"]]
    assert [n for n in want if n in names] == names
    assert set(want) - set(names) <= {"serve_slo_tier1_ttft_p50_ms"}
    val = {r["name"]: r["value"] for r in got["rows"]}
    assert int(val["serve_slo_shed"]) + int(val["serve_slo_expired"]) > 0
    assert float(val["serve_slo_tier0_ttft_p99_ms"]) > 0
    trace = json.loads((tmp_path / "TRACE_serve_slo.json").read_text())
    assert trace["otherData"]["spans"] == int(val["serve_slo_trace_spans"])
    assert "serve_slo" not in trun.NOT_PORTED


def test_obs_gate_measures_both_modes_on_cpu():
    r = obs_overhead_gate.measure(quick=True, device="cpu")
    assert r["off"] > 0 and r["on"] > 0 and r["reps"] == 5
    assert r["ratio"] == r["on"] / r["off"]


def test_run_decode_overlap_quick_on_cpu(tmp_path):
    """The decode_overlap suite through the harness: the reference's row
    names (read from ``benchmarks/decode_overlap_microbench.py``'s source,
    per quick chunk size), both modes measured, the fp32 parity pass, and
    the async engine's trace beside the BENCH file."""
    rc = trun.main(["--device", "cpu", "--quick", "--only",
                    "decode_overlap", "--bench-dir", str(tmp_path)])
    assert rc == 0
    src = (ROOT / "benchmarks" / "decode_overlap_microbench.py").read_text()
    pats = re.findall(r'yield \(f?"([a-z0-9_{}]+)"', src)
    per_chunk = [p for p in pats if "{chunk}" in p]
    want = [p.format(chunk=c) for c in (2, 4, 8) for p in per_chunk] \
        + [p for p in pats if "{" not in p]
    got = json.loads((tmp_path / "BENCH_decode_overlap.json").read_text())
    names = [r["name"] for r in got["rows"]]
    assert names == want
    val = {r["name"]: r["value"] for r in got["rows"]}
    for c in (2, 4, 8):
        for mode in ("sync", "async"):
            assert float(val[f"overlap_c{c}_{mode}_tok_per_s"]) > 0
            assert 0 <= float(val[f"overlap_c{c}_{mode}_host_gap_frac"]) < 1
    assert val["overlap_parity_gather"] == "ok"
    trace = json.loads((tmp_path / "TRACE_decode_overlap.json").read_text())
    assert trace["otherData"]["spans"] == int(val["overlap_trace_spans"])
    assert "decode_overlap" not in trun.NOT_PORTED
