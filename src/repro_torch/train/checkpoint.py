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
  and hands :meth:`save` of the snapshot to a detached host task;
* **sharded** — :func:`gather_to_host` reassembles a sharded state's full
  leaves on rank 0, which writes them with :meth:`save` (the same bytes as
  the single-device save) while the other ranks wait
  (:meth:`CheckpointManager.save_sharded`); :meth:`restore` with
  ``shardings`` gives each rank its blocks, so a state saved at one rank
  count restores at another.
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

__all__ = ["CheckpointManager", "gather_to_host"]


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


def _process_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def gather_to_host(tree: Any, shardings: Any, group) -> Optional[Any]:
    """The full leaves of a sharded ``tree`` (this rank's blocks; a
    ``NamedSharding`` per leaf in ``shardings``), copied into host memory
    on rank 0, leaf by leaf (the device holds one gathered leaf at a time);
    None on the other ranks. Collective over ``group``."""
    out = []
    for t, sh in zip(leaves(tree), leaves(shardings)):
        full = group.gather_leaf(t, sh.spec) if sh is not None else t
        out.append(full.detach().to("cpu", copy=True)
                   if group.rank == 0 else None)
        del full
    return unflatten(tree, out) if group.rank == 0 else None


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

    def save_sharded(self, step: int, tree: Any, shardings: Any,
                     group) -> Optional[Path]:
        """A sharded state's checkpoint: :func:`gather_to_host`, written by
        rank 0 (the bytes :meth:`save` writes for the unsharded state),
        then every rank waits for the write. Collective over ``group``.
        Returns the path on rank 0, None elsewhere."""
        snap = gather_to_host(tree, shardings, group)
        path = self.save(step, snap) if snap is not None else None
        del snap
        group.barrier()
        return path

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

    def restore(self, step: int, example_tree: Any, device=None,
                shardings: Any = None, rank: Optional[int] = None) -> Any:
        """Restore into the structure of ``example_tree``, each leaf in its
        stored dtype, on ``device`` (None: the example leaf's device).
        ``shardings`` (a tree like ``example_tree`` of ``NamedSharding`` or
        None leaves) restores each leaf as ``rank``'s block (default: this
        process's rank in the default process group, else 0): the elastic
        path, whatever the rank count at save."""
        rank = _process_rank() if rank is None else rank
        shards = leaves(shardings) if shardings is not None else None
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
            if shards is not None and shards[i] is not None:
                t = shards[i].shard(t, rank).clone(
                    memory_format=torch.contiguous_format)
            if tuple(t.shape) != tuple(ex.shape):
                raise ValueError(f"leaf {i} shape {tuple(t.shape)} != model "
                                 f"{tuple(ex.shape)}")
            out.append(t.to(ex.device if device is None else device))
        return unflatten(example_tree, out)

    def restore_latest(self, example_tree: Any, device=None,
                       shardings: Any = None, rank: Optional[int] = None
                       ) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, example_tree
        return step, self.restore(step, example_tree, device, shardings,
                                  rank)
