"""Opaque resumable cursors for paginated bigset queries.

A cursor names *where a scan stopped*: the last element-key boundary the
executor emitted.  Because element-keys are stored in lexicographic element
order, resumption is a single storage seek strictly past that element
(``element + b"\\x00"`` is the immediate successor in the order-preserving
codec) — no server-side state, no skip-counting, O(1) to resume regardless
of how many pages came before.  Clients treat tokens as opaque bytes.

Token layout: urlsafe-base64( msgpack([version, scope, last_element]) ||
crc32 ) — the scope binds a token to the query shape that minted it, and the
checksum rejects truncated or spliced tokens.

PyTorch port: a copy of :mod:`repro.query.cursor`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import base64
import binascii
import struct
import zlib
from typing import Optional

import msgpack

CURSOR_VERSION = 1
LEASE_VERSION = 1


class CursorError(ValueError):
    """Malformed, corrupted, or mismatched cursor token."""


class LeaseError(CursorError):
    """Lease token problems: wrong session, corruption, or expiry."""


def encode_cursor(scope: bytes, element: bytes, inclusive: bool = False) -> bytes:
    """Mint an opaque resume token.

    ``inclusive=False`` (the common case) resumes strictly past ``element``
    — the last element a page emitted.  ``inclusive=True`` resumes *at*
    ``element`` — used when a page emitted nothing (e.g. ``limit=0``) and the
    next page must start from the current head.
    """
    payload = msgpack.packb([CURSOR_VERSION, scope, element, bool(inclusive)])
    crc = struct.pack(">I", zlib.crc32(payload))
    return base64.urlsafe_b64encode(payload + crc)


def decode_cursor(token: bytes, scope: bytes) -> "tuple[bytes, bool]":
    """Validate ``token`` against ``scope``; return (element, inclusive)."""
    try:
        raw = base64.urlsafe_b64decode(token)
    except (binascii.Error, ValueError) as e:
        raise CursorError(f"undecodable cursor: {e}") from None
    if len(raw) < 5:
        raise CursorError("cursor too short")
    payload, crc = raw[:-4], raw[-4:]
    if struct.pack(">I", zlib.crc32(payload)) != crc:
        raise CursorError("cursor checksum mismatch")
    try:
        version, tok_scope, element, inclusive = msgpack.unpackb(payload)
    except Exception as e:
        raise CursorError(f"malformed cursor payload: {e}") from None
    if version != CURSOR_VERSION:
        raise CursorError(f"unsupported cursor version {version}")
    if tok_scope != scope:
        raise CursorError("cursor was minted for a different query")
    return element, bool(inclusive)


def wrap_lease(session_id: bytes, cursor: bytes, nonce: int = 0) -> bytes:
    """Bind a raw cursor to one service session as an opaque lease token.

    The serve layer never hands raw cursors to clients: it wraps them so a
    token minted for one session cannot resume another session's scan (the
    lease *deadline* lives server-side in the service's lease table — the
    token only carries the binding).  ``nonce`` keeps tokens distinct even
    when cursors collide byte-for-byte: two identical scans in one session
    must hold two independent leases, or releasing one would strand the
    other.  Same armor as cursors: msgpack payload + crc32, urlsafe base64.
    """
    payload = msgpack.packb([LEASE_VERSION, session_id, cursor, nonce])
    crc = struct.pack(">I", zlib.crc32(payload))
    return base64.urlsafe_b64encode(payload + crc)


def unwrap_lease(token: bytes, session_id: bytes) -> bytes:
    """Validate a lease token against ``session_id``; return the raw cursor."""
    try:
        raw = base64.urlsafe_b64decode(token)
    except (binascii.Error, ValueError) as e:
        raise LeaseError(f"undecodable lease: {e}") from None
    if len(raw) < 5:
        raise LeaseError("lease too short")
    payload, crc = raw[:-4], raw[-4:]
    if struct.pack(">I", zlib.crc32(payload)) != crc:
        raise LeaseError("lease checksum mismatch")
    try:
        version, tok_session, cursor, _nonce = msgpack.unpackb(payload)
    except Exception as e:
        raise LeaseError(f"malformed lease payload: {e}") from None
    if version != LEASE_VERSION:
        raise LeaseError(f"unsupported lease version {version}")
    if tok_session != session_id:
        raise LeaseError("lease belongs to a different session")
    return cursor


def resume_point(
    cursor: Optional[bytes], scope: bytes
) -> "tuple[Optional[bytes], Optional[bytes]]":
    """Decode a cursor into ``(start, after)`` seek arguments.

    Returns ``(None, None)`` for no cursor (scan from the range start),
    ``(element, None)`` for an inclusive token, ``(None, element)`` for the
    usual resume-strictly-past token.
    """
    if cursor is None:
        return None, None
    element, inclusive = decode_cursor(cursor, scope)
    return (element, None) if inclusive else (None, element)
