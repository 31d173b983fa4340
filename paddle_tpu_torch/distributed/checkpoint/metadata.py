"""Checkpoint metadata (parity: `python/paddle/distributed/checkpoint/
metadata.py` — global shape/placement records enabling reshard-on-load).

Integrity format (v2, docs/RESILIENCE.md): every storage entry carries a
per-shard CRC32 (`crc32` over the raw shard bytes, computed as the bytes
stream to disk) which the loader verifies before handing data to the
resharder — bit-rot, torn writes, and truncation surface as
`CheckpointCorruptionError` instead of silently-wrong weights.  v1
checkpoints (no `crc32` key) still load; they simply skip verification.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Tuple

# v1: no integrity records. v2: per-shard crc32 in storage_metadata.
METADATA_VERSION = 2


class CheckpointCorruptionError(RuntimeError):
    """A shard's stored bytes fail integrity verification (CRC mismatch
    or byte-range truncation).  Recovery path: CheckpointManager falls
    back to the previous checkpoint in the rotation."""

    def __init__(self, message, key=None, file=None):
        self.key = key
        self.file = file
        super().__init__(message)


def shard_checksum(raw: bytes, running: int = 0) -> int:
    """CRC32 of one shard's raw bytes (chainable via `running` so the
    writer checksums as it streams)."""
    return zlib.crc32(raw, running) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LocalTensorMetadata:
    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class LocalTensorIndex:
    tensor_key: str
    global_offset: Tuple[int, ...]


@dataclasses.dataclass
class Metadata:
    state_dict_metadata: dict = dataclasses.field(default_factory=dict)
    storage_metadata: dict = dataclasses.field(default_factory=dict)
    flat_mapping: dict = dataclasses.field(default_factory=dict)
    version: int = METADATA_VERSION
