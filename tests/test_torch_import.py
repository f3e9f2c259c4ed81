"""The port stands alone: importing it (and chip_smoke) loads no JAX, and no
file of it imports JAX or the JAX package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]

# `import jax`, `from jax...`, `import repro`, `import repro.x`,
# `from repro.x`, `from repro import` — but never `repro_torch`
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s*$|\s*,)"
    r"|from\s+repro(\.|\s))", re.M)


def test_import_without_gpu_leaves_jax_out():
    code = (
        "import sys\n"
        "sys.path[:0] = ['src', '.']\n"
        "import repro_torch, repro_torch.serve.engine, "
        "repro_torch.launch.serve, repro_torch.kernels.ops, "
        "repro_torch.params, repro_torch.core, repro_torch.pipeline, "
        "repro_torch.core.deviceflow, repro_torch.core.algorithms, "
        "repro_torch.bench.fig13_lsdnn, repro_torch.models.mamba, "
        "repro_torch.kernels.mamba_scan, repro_torch.bench.serve_profile, "
        "repro_torch.optim, repro_torch.data, repro_torch.train, "
        "repro_torch.train.trainer, repro_torch.launch.train, "
        "repro_torch.tree, repro_torch.core.condgraph, "
        "repro_torch.kernels.cond_graph, repro_torch.bench.run, "
        "repro_torch.bench.condgraph_check, "
        "repro_torch.bench.fig17_conditional_memory, "
        "repro_torch.bench.paged_decode_microbench, "
        "repro_torch.bench.pipeline_throughput, "
        "repro_torch.examples.quickstart, repro_torch.obs, "
        "repro_torch.serve.prefix, repro_torch.bench.serve_continuous, "
        "repro_torch.bench.obs_overhead_gate, "
        "repro_torch.serve.faultinject, repro_torch.bench.serve_slo\n"
        "from repro_torch.models.lm import forward, loss_fn\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('imported')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    # importing chip_smoke must not run it: nothing else on stdout
    assert r.stdout.strip() == "imported", r.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_source_imports_neither_jax_nor_repro(path):
    text = path.read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_forbidden_pattern_spares_repro_torch():
    assert _FORBIDDEN.search("from repro.models import lm")
    assert _FORBIDDEN.search("import repro.serve.engine")
    assert _FORBIDDEN.search("from repro import configs")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.models import lm")
    assert not _FORBIDDEN.search("import repro_torch")
    assert not _FORBIDDEN.search("from .repro import x")


@pytest.mark.parametrize("src", ["paged_attention.cu", "flash_attention.cu",
                                 "lsdnn_layer.cu", "mamba_scan.cu"])
def test_kernel_sources_name_the_tpu_kernel_they_replace(src):
    text = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / src) \
        .read_text()
    head = text[:2000]
    assert "src/repro/kernels/" in head and "Replaces" in head
    assert "bound" in head and "Design" in head


def test_cond_graph_source_names_what_it_replaces():
    text = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
            "cond_graph.cu").read_text()
    head = text[:3000]
    assert "src/repro/core/jaxgraph.py" in head and "Replaces" in head
    assert "bound" in head and "Design" in head


@pytest.mark.parametrize("mod", ["serve_profile", "serve_runs",
                                 "fig13_lsdnn"])
def test_bench_scripts_refuse_without_cuda(mod, monkeypatch):
    import importlib

    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = importlib.import_module(f"repro_torch.bench.{mod}")
    with pytest.raises(SystemExit, match="CUDA device"):
        m.main(*([] if mod == "serve_profile" else [[]]))
