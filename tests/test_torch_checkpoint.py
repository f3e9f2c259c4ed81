"""The port's checkpoints: the cases of ``tests/test_checkpoint.py`` (all
but the elastic reshard, which needs a mesh) on torch trees, and the same
bytes on disk as ``repro.train.checkpoint``: a checkpoint written by either
framework restores into the other bit for bit, and both write the same
manifest and data files for the same tree."""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JManager
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import leaves, tree_map


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((16, 8)).astype(np.float32),
                       "b": rng.standard_normal((8,)).astype(np.float32)},
            "opt": {"m": rng.standard_normal((16, 8)).astype(np.float32),
                    "count": np.int32(7)}}


def _tree(seed=0):
    """A torch tree with an fp32, a bf16 and an int32 scalar leaf."""
    t = tree_map(lambda a: torch.from_numpy(np.array(a)), _np_tree(seed))
    t["params"]["b"] = t["params"]["b"].bfloat16()
    return t


def _jtree(seed=0):
    t = jax.tree_util.tree_map(jnp.asarray, _np_tree(seed))
    t["params"]["b"] = t["params"]["b"].astype(jnp.bfloat16)
    return t


def _bits(x) -> np.ndarray:
    """Raw bit pattern of a torch or JAX leaf."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_roundtrip_including_bf16(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(5, t)
    restored = mgr.restore(5, t)
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_partial_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)
    broken = tmp_path / "ckpt_00000009"     # a crash mid-save
    shutil.copytree(tmp_path / "ckpt_00000001", broken)
    (broken / "data" / "0.bin").unlink()
    m = json.loads((broken / "manifest.json").read_text())
    m["step"] = 9
    (broken / "manifest.json").write_text(json.dumps(m))
    assert mgr.latest_step() == 1
    step, _ = mgr.restore_latest(t)
    assert step == 1


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"params": {"w": torch.zeros((16, 8))}})


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)
    bad = tree_map(lambda x: torch.zeros((2, *x.shape), dtype=x.dtype), t)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad)


def test_jax_checkpoint_restores_into_port_bit_for_bit(tmp_path):
    JManager(tmp_path).save(3, _jtree())
    step, got = CheckpointManager(tmp_path).restore_latest(_tree(1))
    assert step == 3
    want = _tree()
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path):
    CheckpointManager(tmp_path).save(4, _tree())
    step, got = JManager(tmp_path).restore_latest(_jtree(1))
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(_jtree())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_both_frameworks_write_the_same_files(tmp_path):
    a = JManager(tmp_path / "jax").save(2, _jtree())
    b = CheckpointManager(tmp_path / "torch").save(2, _tree())
    assert (a / "manifest.json").read_bytes() == \
        (b / "manifest.json").read_bytes()
    n = json.loads((a / "manifest.json").read_text())["num_leaves"]
    for i in range(n):
        assert (a / "data" / f"{i}.bin").read_bytes() == \
            (b / "data" / f"{i}.bin").read_bytes()
