"""Engine snapshot container: checksummed, versioned state files.

Durability boundary #2 (see ``docs/robustness.md``): where the journal
(:mod:`repro_torch.serve.journal`) makes *requests* recoverable by replay,
the snapshot makes *state that is expensive to recompute* survive a
restart — the prefix trie with its stable blake2b chunk keys, every
parked block's KV page, and the waiting-queue descriptors captured at
drain time. A warm-started engine answers a known system prompt from
the prefix cache on the FIRST post-restart request (``prefix.warm_hits``).

File format — torn-write and corruption safe by construction::

    MAGIC "RSNAPv1\\n"  | 8-byte big-endian payload length
    16-byte blake2b digest of the payload | payload (npz, pickle-free)

The payload is a standard ``.npz`` archive (``meta`` is a JSON string
stored as a 0-d unicode array; every other entry is a plain ndarray —
``allow_pickle=False`` on load, so a corrupted file can never execute
anything). Writes go to a temp file + ``os.replace`` so a crash during
:func:`write_snapshot` leaves the previous snapshot intact; any
mismatch on read — short file, bad magic, bad length, digest mismatch,
bad JSON, wrong version — raises typed :class:`SnapshotCorrupt`, and
callers (``ServeEngine.recover``, ``repro_torch.launch.serve --state-dir``) fall
back to a cold start. A snapshot can lose warmth; it can never serve
wrong tokens.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from .errors import SnapshotCorrupt

__all__ = ["MAGIC", "SNAPSHOT_VERSION", "write_snapshot", "read_snapshot",
           "corrupt_snapshot"]

MAGIC = b"RSNAPv1\n"
SNAPSHOT_VERSION = 1

_DIGEST_SIZE = 16


def _digest(payload: bytes) -> bytes:
    return hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest()


def write_snapshot(path: str, meta: Dict[str, Any],
                   arrays: Dict[str, np.ndarray]) -> int:
    """Write ``meta`` + ``arrays`` atomically; returns bytes written."""
    meta = dict(meta)
    meta["version"] = SNAPSHOT_VERSION
    buf = io.BytesIO()
    np.savez(buf, meta=np.array(json.dumps(meta, sort_keys=True)),
             **{k: np.ascontiguousarray(v) for k, v in arrays.items()})
    payload = buf.getvalue()
    blob = MAGIC + len(payload).to_bytes(8, "big") + _digest(payload) \
        + payload
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(blob)


def read_snapshot(path: str) -> Tuple[Dict[str, Any],
                                      Dict[str, np.ndarray]]:
    """Load and verify a snapshot; raises :class:`SnapshotCorrupt` on
    any integrity failure (callers cold-start)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise SnapshotCorrupt(f"snapshot unreadable: {e}") from e
    head = len(MAGIC) + 8 + _DIGEST_SIZE
    if len(blob) < head or blob[:len(MAGIC)] != MAGIC:
        raise SnapshotCorrupt("snapshot missing or bad magic header")
    plen = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 8], "big")
    digest = blob[len(MAGIC) + 8:head]
    payload = blob[head:]
    if len(payload) != plen:
        raise SnapshotCorrupt(
            f"snapshot truncated: payload {len(payload)} != header {plen}")
    if _digest(payload) != digest:
        raise SnapshotCorrupt("snapshot payload checksum mismatch")
    try:
        npz = np.load(io.BytesIO(payload), allow_pickle=False)
        arrays = {k: npz[k] for k in npz.files if k != "meta"}
        meta = json.loads(str(npz["meta"]))
    except Exception as e:
        raise SnapshotCorrupt(f"snapshot payload undecodable: {e}") from e
    if not isinstance(meta, dict) \
            or meta.get("version") != SNAPSHOT_VERSION:
        raise SnapshotCorrupt(
            f"snapshot version mismatch: {meta.get('version')!r} "
            f"!= {SNAPSHOT_VERSION}")
    return meta, arrays


def corrupt_snapshot(path: str) -> None:
    """Flip one payload byte in place — the ``snapshot_corrupt`` fault
    site and the recovery tests use this to prove the typed cold-start
    fallback (a real torn write corrupts less politely; the checksum
    catches both)."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        pos = len(MAGIC) + 8 + _DIGEST_SIZE + max(0, (size - 32)) // 2
        pos = min(pos, size - 1)
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
