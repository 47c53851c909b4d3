"""Durable ordered key/value substrate (leveldb stand-in).

The paper's contribution is storage co-design: bigset decomposes a CRDT set
across a *range of keys* in an ordered store and modifies compaction to
consult the set-tombstone.  This package provides that substrate with full
byte accounting (bytes read / written / compacted), which is the cost model
the paper's §2.1 analysis and Figures 1-3 are built on.

PyTorch port: a copy of :mod:`repro.storage`; everything below
this docstring is unchanged.
"""
from .keycodec import KeyCodecError, decode_key, encode_key
from .lsm import IoStats, LsmStore
from .wal import (CrashError, CrashPoint, DurableMedia, RecoveryResult,
                  WalError)

__all__ = [
    "encode_key", "decode_key", "KeyCodecError", "LsmStore", "IoStats",
    "DurableMedia", "CrashPoint", "CrashError", "RecoveryResult", "WalError",
]
