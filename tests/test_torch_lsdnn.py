"""The sparse-DNN (LSDNN) slice of the port against the JAX reference, on
the CPU: K4's plain version, the fig13 bench's generators and its paths.

* ``repro_torch.kernels.lsdnn_layer`` on CPU tensors (the plain version)
  vs ``repro.kernels.ops.lsdnn_layer`` (the Pallas kernel in interpret
  mode) and ``repro.kernels.ref.lsdnn_layer_ref`` on the cases of
  ``tests/test_kernels.py`` (the cap test included), plus a ragged T, F
  and G that the TPU kernel does not take. Tolerances: fp32 1e-5 absolute
  (the same fp32 products summed in another order; outputs below ~5);
  bf16 one bf16 ulp of the output, ``|a - b| <= 2**-7 |b|`` (both round the
  same fp32 sum, whose last bits may differ, to bf16), and the reference
  test's 0.3 against the Pallas kernel.
* ``repro_torch.bench.fig13_lsdnn``: its ``fig13`` generator byte for byte
  against ``benchmarks/fig13_lsdnn._make_net``; its taskflow path at 8
  layers x 64 neurons against the JAX bench's counts and the reference's
  chained layers (1e-5 absolute); the ``hpec`` generator's invariants.

K4 itself runs only on the card: ``tests/test_torch_kernels_gpu.py``.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import lsdnn_layer as j_lsdnn
from repro.kernels.ref import lsdnn_layer_ref as j_lsdnn_ref
from repro_torch.bench import fig13_lsdnn as tb
from repro_torch.kernels import lsdnn_layer as lsdnn_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import lsdnn_layer_ref

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the reference's benchmarks package
    sys.path.insert(0, str(ROOT))

from benchmarks import fig13_lsdnn as jb  # noqa: E402

TOL32 = 1e-5
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(T, F, G, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((T, F)).astype(np.float32)
    w = (rng.standard_normal((F, G)) * 0.05).astype(np.float32)
    b = rng.standard_normal(G).astype(np.float32)
    return y, w, b


def _both(arrs, dtype):
    """The same values in both frameworks (bf16: both round fp32 to
    nearest even)."""
    jd, td = DT[dtype]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("T,F,G,dtype", [
    (128, 256, 128, "float32"),
    (256, 128, 64, "float32"),
    (64, 64, 64, "bfloat16"),
])
def test_plain_matches_pallas_interpret_and_ref(T, F, G, dtype):
    (jy, jw, jb_), (ty, tw, tb_) = _both(_case(T, F, G), dtype)
    got = lsdnn_mod.lsdnn_layer(ty, tw, tb_)
    assert got.dtype == ty.dtype and got.shape == (T, G)
    pallas = _f32(j_lsdnn(jy, jw, jb_, block_m=64, block_n=64, block_k=64))
    ref = _f32(j_lsdnn_ref(jy, jw, jb_))
    g = _f32(got)
    if dtype == "float32":
        np.testing.assert_allclose(g, pallas, rtol=0, atol=TOL32)
        np.testing.assert_allclose(g, ref, rtol=0, atol=TOL32)
    else:
        assert np.max(np.abs(g - pallas)) < 0.3
        assert np.all(np.abs(g - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-30)


def test_plain_clamps_at_cap():
    y = np.full((64, 64), 10.0, np.float32)
    w = np.ones((64, 64), np.float32)
    b = np.zeros(64, np.float32)
    (jy, jw, jb_), (ty, tw, tb_) = _both((y, w, b), "float32")
    got = lsdnn_mod.lsdnn_layer(ty, tw, tb_, cap=32.0).numpy()
    pallas = np.asarray(j_lsdnn(jy, jw, jb_, cap=32.0, block_m=64,
                                block_n=64, block_k=64))
    assert float(got.max()) == 32.0 and float(got.min()) >= 0.0
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ragged_shapes_match_ref(dtype):
    """T = 100, F = 72, G = 40: not tile multiples (the TPU kernel asserts
    them, the port's kernel masks)."""
    (jy, jw, jb_), (ty, tw, tb_) = _both(_case(100, 72, 40, seed=3), dtype)
    g = _f32(lsdnn_mod.lsdnn_layer(ty, tw, tb_, cap=1.5))
    ref = _f32(j_lsdnn_ref(jy, jw, jb_, cap=1.5))
    assert g.max() == 1.5 and g.min() == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(g, ref, rtol=0, atol=TOL32)
    else:
        assert np.all(np.abs(g - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-30)


def test_cpu_tensors_launch_nothing_and_cuda_entry_refuses_them():
    ty, tw, tb_ = (torch.from_numpy(a) for a in _case(8, 8, 8))
    n0 = ops.launch_counts()["lsdnn_layer"]
    out = ops.lsdnn_layer(ty, tw, tb_)
    assert ops.launch_counts()["lsdnn_layer"] == n0
    torch.testing.assert_close(out, lsdnn_layer_ref(ty, tw, tb_),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        lsdnn_mod.lsdnn_layer_cuda(ty, tw, tb_)


@pytest.mark.parametrize("layers,neurons,seed", [(4, 32, 0), (3, 64, 5)])
def test_fig13_generator_is_the_reference_make_net(layers, neurons, seed):
    ws, b, y0 = jb._make_net(layers, neurons, seed)
    net = tb.make_fig13(layers, neurons, seed)
    assert len(net.ws) == len(ws)
    for a, e in zip(net.ws + [net.b, net.y0], ws + [b, y0]):
        assert a.dtype == e.dtype and a.shape == e.shape
        assert a.tobytes() == e.tobytes()


def test_taskflow_path_matches_jax_bench():
    """8 layers x 64 neurons, block 4, 3 passes: the port's three paths
    against the JAX bench's launch and task counts, and the taskflow
    output against the reference's layers chained over the same passes."""
    layers, neurons, block, passes = 8, 64, 4, 3
    jrows = {n: v for n, v, _ in jb.bench(layers=layers, neurons=neurons,
                                          block=block, passes=passes)}
    res = tb.run_paths(tb.make_fig13(layers, neurons), passes, block,
                       torch.device("cpu"))
    rows = {n: v for n, v, _ in tb.rows_of(res)}
    for key in ("sequential_launches", "unrolled_launches",
                "unrolled_tasks", "taskflow_launches", "taskflow_tasks"):
        assert rows[f"fig13/{key}"] == jrows[f"fig13/{key}"], key
    assert rows["fig13/taskflow_launches"] == passes
    ws, b, y0 = jb._make_net(layers, neurons)
    y = jnp.asarray(y0)
    for _ in range(passes):
        for w in ws:
            y = j_lsdnn_ref(y, jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(res["taskflow"].y, np.asarray(y), rtol=0,
                               atol=TOL32)
    # all three paths run the same chained passes on the same plain layer
    assert rows["fig13/result_max_err"] == 0.0
    assert res["taskflow"].graph["replays"] == passes + 1   # + warm-up


def test_hpec_generator_invariants():
    net = tb.make_hpec(layers=3, neurons=128, rows=500, seed=1)
    assert len(net.ws) == 3 and net.y0.shape == (500, 128)
    for w in net.ws:
        assert w.dtype == np.float32 and w.shape == (128, 128)
        assert np.all((w != 0).sum(axis=0) == tb.HPEC_NNZ)
        assert np.all(w[w != 0] == np.float32(1 / 16))
    assert net.b.dtype == np.float32
    assert np.all(net.b == np.float32(-0.3))
    assert net.cap == 32.0
    assert set(np.unique(net.y0)) <= {0.0, 1.0}
    assert abs(net.y0.mean() - 0.3) < 0.02
    again = tb.make_hpec(layers=3, neurons=128, rows=500, seed=1)
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(net.ws + [net.y0], again.ws + [again.y0]))
    other = tb.make_hpec(layers=3, neurons=128, rows=500, seed=2)
    assert other.ws[0].tobytes() != net.ws[0].tobytes()


def test_hpec_network_keeps_some_rows_and_not_all():
    """The challenge's full network (120 layers x 1024 neurons) on 64 of
    its input rows: after one pass the categories (rows with any nonzero
    output) are neither empty nor every row, and active rows sit at the
    cap."""
    net = tb.make_hpec(rows=64, seed=0)
    y = tb.plain_output(net, 1, torch.device("cpu"))
    cats = tb.categories(y)
    assert 0 < len(cats) < 64
    assert y.max() == 32.0 and y.min() == 0.0


def test_kernel_sources_are_built_and_rebuild_by_hash(tmp_path, monkeypatch):
    """Every ``csrc/*.cu`` is compiled and bound, and an edit of K4's source
    changes the build directory's hash (so it is rebuilt, not reloaded)."""
    import shutil

    from repro_torch.kernels import _build
    assert sorted(_build.SOURCES) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    assert "repro_lsdnn_layer" in _build._SIGNATURES
    shutil.copytree(_build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    before = _build._digest()
    src = tmp_path / "csrc" / "lsdnn_layer.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._digest() != before
