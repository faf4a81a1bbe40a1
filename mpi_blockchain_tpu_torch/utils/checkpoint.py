"""Crash-safe chain checkpoint and resume.

The port's copy of the reference's ``utils/checkpoint.py``; a file either
package writes, the other loads. A checkpoint is the chain's canonical
wire format (concatenated 80-byte headers, the bytes ``Node.save`` emits)
plus an integrity trailer, and a JSON sidecar with the config, so resume
can refuse a difficulty mismatch instead of mining an invalid suffix.
There is no device state to save: the search is stateless per block.

* **Atomic writes.** Payload and sidecar are written tmp → flush → fsync
  → ``os.replace`` (+ a best-effort directory fsync), so a crash mid-save
  leaves the previous checkpoint whole at the published path.
* **Torn writes are detected.** The payload carries a 48-byte trailer:
  ``MBTCKPT\\x01`` + u64 payload length + SHA-256(payload). ``load_chain``
  refuses any mismatch (``CheckpointError``), and a v2 sidecar without an
  intact trailer is itself proof of a tear: a file torn on an 80-byte
  boundary never loads as a shorter chain.
* **Recovery truncates to the last valid block.** ``recover_chain`` (the
  ``mine --resume`` path) drops a torn tail, re-validates the longest
  loadable header prefix, rewrites the repaired checkpoint atomically and
  reports what it dropped.
* **Legacy files load.** A file with no trailer and no v2 sidecar
  validates through the C++ loader.

The ``checkpoint.write`` and ``checkpoint.read`` fault sites produce torn,
bitrotted or unreadable checkpoints on demand. The reference's ``mesh``
sidecar field (the elastic world's membership) waits for the elastic mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import struct

from .. import core
from ..config import ConfigError, MinerConfig
from ..resilience import injection

MAGIC = b"MBTCKPT\x01"
TRAILER_SIZE = len(MAGIC) + 8 + 32   # magic + u64 payload_len + sha256
SIDECAR_VERSION = 2


class CheckpointError(ConfigError):
    """Integrity failure: torn write, bitrot, or an invalid chain. A
    ConfigError, so the CLI's clean-error contract holds; a class of its
    own, so ``recover_chain`` can tell a damaged file (recover) from a
    wrong config (refuse)."""


def _sidecar_path(path: pathlib.Path) -> pathlib.Path:
    return path.with_suffix(path.suffix + ".json")


def _atomic_write(path: pathlib.Path, data: bytes,
                  fsync: bool = True) -> None:
    """tmp + flush + fsync + rename: the published path only ever holds a
    complete file. The pid suffix keeps two processes that save to one
    path from clobbering each other's tmp."""
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        try:
            dfd = os.open(path.parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            # Directory fsync is best-effort (not every file system
            # allows it); the rename itself is already atomic.
            return


def seal(payload: bytes) -> bytes:
    """Payload + the integrity trailer ``load_chain`` verifies."""
    return payload + MAGIC + struct.pack("<Q", len(payload)) + \
        hashlib.sha256(payload).digest()


def split_trailer(blob: bytes) -> tuple[bytes, bool]:
    """Splits a checkpoint blob into (payload, verified).

    ``verified`` is True when an intact trailer authenticated the payload;
    False when there is no trailer (a legacy file, or a tear, which the
    sidecar tells apart). A present but inconsistent trailer raises: that
    can only be corruption.
    """
    if len(blob) >= TRAILER_SIZE and \
            blob[-TRAILER_SIZE:-40] == MAGIC:
        payload = blob[:-TRAILER_SIZE]
        length, = struct.unpack("<Q", blob[-40:-32])
        digest = blob[-32:]
        if length != len(payload) or \
                hashlib.sha256(payload).digest() != digest:
            raise CheckpointError(
                "checkpoint trailer mismatch (torn write or bitrot): "
                f"trailer claims {length} payload bytes, "
                f"file holds {len(payload)}")
        return payload, True
    return blob, False


def save_chain(node: core.Node, path: str | pathlib.Path,
               config: MinerConfig | dict | None = None,
               fsync: bool = True) -> pathlib.Path:
    """Atomically writes the chain checkpoint + sidecar; returns the path.
    ``config`` may be a MinerConfig or an already serialized config dict
    (the recovery rewrite keeps the original sidecar's)."""
    from ..resilience import FaultInjected
    from ..telemetry import counter
    from ..telemetry.events import emit_event

    path = pathlib.Path(path)
    payload = node.save()
    blob = seal(payload)
    fault = injection.check("checkpoint.write", path=str(path),
                            height=node.height)
    if fault is not None and fault.kind == "partial":
        # The injected torn write: bypass the atomic path and publish a
        # truncated file directly, the state a crash mid-write of a
        # non-atomic writer leaves, then die as the crash would.
        with open(path, "wb") as f:
            f.write(blob[:max(1, len(blob) // 2)])
        raise FaultInjected("checkpoint.write", "partial",
                            fault.message or f"torn checkpoint write "
                            f"at {path}")
    meta = {"checkpoint_version": SIDECAR_VERSION,
            "height": node.height, "tip_hash": node.tip_hash.hex(),
            "difficulty_bits": node.difficulty_bits,
            "payload_len": len(payload),
            "payload_sha256": hashlib.sha256(payload).hexdigest()}
    if config is not None:
        meta["config"] = (config if isinstance(config, dict)
                          else dataclasses.asdict(config))
    _atomic_write(path, blob, fsync=fsync)
    _atomic_write(_sidecar_path(path),
                  json.dumps(meta, sort_keys=True).encode(), fsync=fsync)
    if fault is not None and fault.kind == "corrupt":
        # Injected bitrot: flip one payload byte of the published file
        # after a clean write (rot happens at rest, not in flight).
        rotted = bytearray(path.read_bytes())
        rotted[len(rotted) // 2] ^= 0xFF
        path.write_bytes(bytes(rotted))
    counter("checkpoints_saved_total",
            help="chain checkpoints written (atomic, sealed)").inc()
    emit_event({"event": "checkpoint_saved", "height": node.height,
                "path": str(path)})
    return path


def _sidecar_version(meta: dict) -> int:
    """The sidecar's checkpoint_version as an int; a non-numeric value is
    sidecar corruption (CheckpointError, so ``recover_chain`` can still
    salvage an intact payload), never a TypeError."""
    v = meta.get("checkpoint_version", 1)
    try:
        return int(v)
    except (TypeError, ValueError):
        raise CheckpointError(
            f"corrupt checkpoint sidecar: non-numeric "
            f"checkpoint_version {v!r}") from None


def _read_sidecar(path: pathlib.Path) -> dict | None:
    sidecar = _sidecar_path(path)
    if not sidecar.exists():
        return None
    try:
        meta = json.loads(sidecar.read_text())
    except json.JSONDecodeError as e:
        raise CheckpointError(
            f"corrupt checkpoint sidecar {sidecar}: {e}") from e
    if not isinstance(meta, dict):
        raise CheckpointError(f"corrupt checkpoint sidecar {sidecar}: "
                              f"not a JSON object")
    return meta


def open_checkpoint(path: str | pathlib.Path,
                    blob: bytes | None = None
                    ) -> tuple[bytes, bool, dict | None]:
    """Checks a checkpoint blob against its trailer and its sidecar;
    returns (payload, sealed, sidecar_meta). The shared gate of
    ``load_chain`` and ``verify --chain``: a v2 sidecar whose trailer is
    gone (a tear exactly on the trailer's boundary) or whose digest
    disagrees raises here, so neither reader takes a torn file for a
    valid shorter chain. Legacy files (no trailer, no v2 sidecar) pass
    through unsealed."""
    path = pathlib.Path(path)
    if blob is None:
        blob = path.read_bytes()
    meta = _read_sidecar(path)
    payload, verified = split_trailer(blob)
    sealed_meta = meta is not None and (
        _sidecar_version(meta) >= 2 or "payload_sha256" in meta)
    if sealed_meta and not verified:
        raise CheckpointError(
            f"torn checkpoint write detected: sidecar declares a sealed "
            f"v{_sidecar_version(meta)} checkpoint but {path} "
            f"has no intact trailer")
    if sealed_meta and meta.get("payload_sha256") != \
            hashlib.sha256(payload).hexdigest():
        raise CheckpointError(
            f"checkpoint payload digest does not match its sidecar: "
            f"{path} (torn write or bitrot)")
    if not payload or len(payload) % core.HEADER_SIZE:
        raise CheckpointError(
            f"torn or empty chain checkpoint: {path} holds "
            f"{len(payload)} bytes, not a whole number of "
            f"{core.HEADER_SIZE}-byte headers")
    return payload, verified, meta


def load_chain(path: str | pathlib.Path, difficulty_bits: int,
               node_id: int = 0) -> core.Node:
    """Restores a Node from a checkpoint, checking it end to end: trailer
    (or a tear the sidecar declares), sidecar digest, difficulty, then the
    C++ re-validation of every block."""
    path = pathlib.Path(path)
    fault = injection.check("checkpoint.read", path=str(path))
    blob = path.read_bytes()
    if fault is not None:
        if fault.kind == "corrupt":
            rotted = bytearray(blob)
            rotted[len(rotted) // 2] ^= 0xFF
            blob = bytes(rotted)
        elif fault.kind == "partial":
            blob = blob[:max(1, len(blob) // 2)]
    meta = _read_sidecar(path)
    if meta is not None and meta.get("difficulty_bits") != difficulty_bits:
        raise ConfigError(
            f"checkpoint difficulty {meta.get('difficulty_bits')} != "
            f"requested {difficulty_bits}")
    payload, _, _ = open_checkpoint(path, blob)
    node = core.Node(difficulty_bits, node_id)
    if not node.load(payload):
        raise CheckpointError(f"invalid or corrupt chain checkpoint: "
                              f"{path}")
    return node


def recover_chain(path: str | pathlib.Path, difficulty_bits: int,
                  node_id: int = 0) -> tuple[core.Node, dict]:
    """``mine --resume``'s loader: load, or truncate a torn tail to the
    last valid block and load that.

    Only integrity damage (CheckpointError) triggers recovery; a
    difficulty mismatch or an unreadable file still refuses, since
    recovering from a wrong checkpoint would be silent corruption. On
    recovery the repaired checkpoint is rewritten atomically, and the
    report says what was dropped: ``{"recovered", "height",
    "dropped_bytes"}``.
    """
    from ..telemetry import counter
    from ..telemetry.events import emit_event

    path = pathlib.Path(path)
    try:
        node = load_chain(path, difficulty_bits, node_id)
        return node, {"recovered": False, "height": node.height,
                      "dropped_bytes": 0}
    except CheckpointError as damage:
        blob = path.read_bytes()
        try:
            payload, _ = split_trailer(blob)
        except CheckpointError:
            # A present but inconsistent trailer is still metadata, not
            # chain bytes: strip it, so dropped_bytes counts chain data
            # only (bitrot in the digest alone loses 0 bytes).
            payload = blob
            if len(blob) >= TRAILER_SIZE and \
                    blob[-TRAILER_SIZE:-40] == MAGIC:
                payload = blob[:-TRAILER_SIZE]
        try:
            meta = _read_sidecar(path) or {}
        except CheckpointError:
            meta = {}        # the sidecar itself is corrupt: nothing to keep
        config = meta.get("config")
        usable = payload[:len(payload) - len(payload) % core.HEADER_SIZE]
        for k in range(len(usable) // core.HEADER_SIZE, 0, -1):
            node = core.Node(difficulty_bits, node_id)
            if node.load(usable[:k * core.HEADER_SIZE]):
                # Chain bytes lost, measured against the payload (the
                # trailer is metadata).
                dropped = len(payload) - k * core.HEADER_SIZE
                counter("checkpoint_recoveries_total",
                        help="torn checkpoints truncated to their last "
                             "valid block on resume").inc()
                emit_event({"event": "checkpoint_truncated",
                            "path": str(path), "height": node.height,
                            "dropped_bytes": dropped,
                            "damage": str(damage)})
                # Rewrite the repaired file, keeping the original
                # sidecar's run config when it survived.
                save_chain(node, path, config)
                return node, {"recovered": True, "height": node.height,
                              "dropped_bytes": dropped}
        raise
