"""Atomic, restartable checkpoints (torch port of
``repro.train.checkpoint``), byte for byte the reference's format.

Layout:  <dir>/ckpt_<step:08d>/
            manifest.json       step, leaf count, tree description, each
                                leaf's shape and dtype, a hash
            data/<i>.bin        raw little-endian buffers (bf16 as its
                                uint16 pattern)

Leaves are numbered in ``jax.tree_util``'s flatten order (dict keys sorted,
depth first; :mod:`repro_torch.tree`), so a checkpoint written by the JAX
package restores here and the reverse. ``treedef`` is a description in the
reference's spelling; neither side reads it back.

* **atomicity** — a save goes to ``.tmp-<step>`` and is renamed only after
  the manifest, written last, is fsynced; a crashed save is never taken for
  a checkpoint;
* **restart** — :meth:`CheckpointManager.restore_latest` picks the newest
  complete checkpoint (:meth:`all_steps` accepts a directory only when its
  manifest parses and every data file is there); ``restore`` checks the
  leaf count and each shape;
* **async** — the trainer snapshots to host memory on its critical path
  and hands :meth:`save` of the snapshot to a detached host task.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves, treedef_str, unflatten

__all__ = ["CheckpointManager"]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_raw(raw: bytes, meta: Dict[str, Any]) -> torch.Tensor:
    shape = meta["shape"]
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, np.dtype(meta["dtype"])).reshape(shape)
    return torch.from_numpy(arr.copy())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> Path:
        """Blocking save of a tree of tensors (call it from a host task for
        an async save; give it host copies if training goes on)."""
        flat = leaves(tree)
        tmp = self.dir / f".tmp-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "data").mkdir(parents=True)
        metas: List[Dict] = []
        h = hashlib.sha256()
        for i, leaf in enumerate(flat):
            buf = _to_numpy(leaf).tobytes()
            h.update(buf[:4096])
            with open(tmp / "data" / f"{i}.bin", "wb") as f:
                f.write(buf)
            metas.append({"shape": list(leaf.shape),
                          "dtype": _dtype_name(leaf)})
        manifest = {"step": step, "num_leaves": len(flat),
                    "treedef": treedef_str(tree), "leaves": metas,
                    "hash": h.hexdigest()}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self.dir / f"ckpt_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def _gc(self) -> None:
        ckpts = self.all_steps()
        for s in ckpts[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"ckpt_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("ckpt_*"):
            mf = p / "manifest.json"
            if not mf.exists():
                continue
            try:
                m = json.loads(mf.read_text())
                n = m["num_leaves"]
                if all((p / "data" / f"{i}.bin").exists() for i in range(n)):
                    out.append(int(m["step"]))
            except (json.JSONDecodeError, KeyError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, example_tree: Any, device=None) -> Any:
        """Restore into the structure of ``example_tree``, each leaf in its
        stored dtype, on ``device`` (None: the example leaf's device)."""
        path = self.dir / f"ckpt_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        ex_leaves = leaves(example_tree)
        if manifest["num_leaves"] != len(ex_leaves):
            raise ValueError(
                f"checkpoint has {manifest['num_leaves']} leaves, "
                f"model expects {len(ex_leaves)}")
        out = []
        for i, (meta, ex) in enumerate(zip(manifest["leaves"], ex_leaves)):
            t = _from_raw((path / "data" / f"{i}.bin").read_bytes(), meta)
            if tuple(t.shape) != tuple(ex.shape):
                raise ValueError(f"leaf {i} shape {tuple(t.shape)} != model "
                                 f"{tuple(ex.shape)}")
            out.append(t.to(ex.device if device is None else device))
        return unflatten(example_tree, out)

    def restore_latest(self, example_tree: Any, device=None
                       ) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, example_tree
        return step, self.restore(step, example_tree, device)
