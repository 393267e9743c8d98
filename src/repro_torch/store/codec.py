"""Columnar shard codec: byte-identical encode, checksummed decode.

One shard file holds a set of named 1-D/2-D numpy columns as contiguous
little-endian blocks, each independently compressed and CRC-checked,
plus a small JSON header describing the blocks and carrying free-form
shard metadata.  Layout::

    [ 0: 8)  magic   b"RPRSTOR1"
    [ 8:12)  u32 LE  format version (CODEC_VERSION)
    [12:20)  u64 LE  header length H
    [20:24)  u32 LE  crc32 of the header bytes
    [24:24+H)        header JSON (sorted keys, compact separators)
    [24+H: )         column payload blocks, back-to-back

The header's ``columns`` list is sorted by column name and records, per
column: dtype string, shape, codec name, compressed/raw byte counts and
the crc32 of the *uncompressed* bytes.  Everything about the encoding is
canonical — sorted column order, sorted-key compact JSON, a fixed zlib
level — so encoding the same columns twice yields byte-identical files
(the reproducibility contract the store's acceptance tests gate on).

Decode verifies magic, version, header crc and every column crc;
corruption raises :class:`ShardChecksumError` (a
:class:`ShardFormatError`) instead of returning silently wrong arrays.
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Optional

import numpy as np

__all__ = ["CODEC_VERSION", "MAGIC", "COMPRESSIONS", "ZLIB_LEVEL",
           "ShardFormatError", "ShardChecksumError",
           "encode_shard", "decode_shard", "read_shard", "peek_meta"]

MAGIC = b"RPRSTOR1"
CODEC_VERSION = 1
ZLIB_LEVEL = 6                      # fixed: part of the canonical encoding
COMPRESSIONS = ("none", "zlib")

_HDR_FIXED = len(MAGIC) + 4 + 8 + 4


class ShardFormatError(ValueError):
    """The byte stream is not a valid shard (bad magic/version/header)."""


class ShardChecksumError(ShardFormatError):
    """A stored checksum does not match the decoded bytes."""


def _canonical_dtype(dt: np.dtype) -> np.dtype:
    """Little-endian is the one true byte order on disk.  ``dt.str``
    resolves native ('=') order, so this also catches native dtypes on
    big-endian hosts — shard bytes must not depend on the writer."""
    if dt.str.startswith(">"):
        return dt.newbyteorder("<")
    return dt


def encode_shard(columns: dict[str, np.ndarray], *,
                 meta: Optional[dict[str, Any]] = None,
                 compression: str = "zlib") -> bytes:
    """Serialize named columns (+ JSON-able ``meta``) into shard bytes."""
    if compression not in COMPRESSIONS:
        raise ValueError(f"unknown compression {compression!r}; "
                         f"choose from {COMPRESSIONS}")
    entries = []
    blocks = []
    for name in sorted(columns):
        arr = np.ascontiguousarray(columns[name])
        arr = arr.astype(_canonical_dtype(arr.dtype), copy=False)
        raw = arr.tobytes()
        enc = zlib.compress(raw, ZLIB_LEVEL) if compression == "zlib" \
            else raw
        # Tiny/incompressible columns: zlib can expand; store whichever
        # is smaller, per column (the header records the choice).
        codec = compression
        if compression == "zlib" and len(enc) >= len(raw):
            enc, codec = raw, "none"
        entries.append({
            "name": name,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "codec": codec,
            "raw_bytes": len(raw),
            "enc_bytes": len(enc),
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
        })
        blocks.append(enc)
    header = {"version": CODEC_VERSION, "columns": entries,
              "meta": meta or {}}
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode()
    out = bytearray()
    out += MAGIC
    out += CODEC_VERSION.to_bytes(4, "little")
    out += len(hdr).to_bytes(8, "little")
    out += (zlib.crc32(hdr) & 0xFFFFFFFF).to_bytes(4, "little")
    out += hdr
    for b in blocks:
        out += b
    return bytes(out)


def _parse_header(data: bytes) -> tuple[dict, int]:
    if len(data) < _HDR_FIXED:
        raise ShardFormatError("shard truncated before header")
    if data[:len(MAGIC)] != MAGIC:
        raise ShardFormatError(f"bad magic {data[:len(MAGIC)]!r}")
    off = len(MAGIC)
    version = int.from_bytes(data[off:off + 4], "little")
    if version != CODEC_VERSION:
        raise ShardFormatError(f"unsupported shard version {version}")
    off += 4
    hlen = int.from_bytes(data[off:off + 8], "little")
    off += 8
    hcrc = int.from_bytes(data[off:off + 4], "little")
    off += 4
    hdr = data[off:off + hlen]
    if len(hdr) != hlen:
        raise ShardFormatError("shard truncated inside header")
    if (zlib.crc32(hdr) & 0xFFFFFFFF) != hcrc:
        raise ShardChecksumError("header crc mismatch")
    try:
        header = json.loads(hdr.decode())
    except ValueError as e:
        raise ShardFormatError(f"header is not valid JSON: {e}") from e
    return header, off + hlen


def peek_meta(data: bytes) -> dict:
    """Header ``meta`` without touching any payload block."""
    header, _ = _parse_header(data)
    return header.get("meta", {})


def decode_shard(data: bytes, *, columns: Optional[list[str]] = None
                 ) -> tuple[dict[str, np.ndarray], dict]:
    """-> (columns, meta).  ``columns`` restricts which blocks are decoded
    (the others are skipped without decompression); every decoded block's
    crc is verified."""
    header, off = _parse_header(data)
    want = None if columns is None else set(columns)
    out: dict[str, np.ndarray] = {}
    for ent in header["columns"]:
        enc = data[off:off + ent["enc_bytes"]]
        off += ent["enc_bytes"]
        if len(enc) != ent["enc_bytes"]:
            raise ShardFormatError(
                f"shard truncated inside column {ent['name']!r}")
        if want is not None and ent["name"] not in want:
            continue
        if ent["codec"] == "zlib":
            try:
                raw = zlib.decompress(enc)
            except zlib.error as e:
                raise ShardChecksumError(
                    f"column {ent['name']!r} failed to decompress "
                    f"(corrupted shard): {e}") from e
        else:
            raw = enc
        if len(raw) != ent["raw_bytes"] or \
                (zlib.crc32(raw) & 0xFFFFFFFF) != ent["crc32"]:
            raise ShardChecksumError(
                f"column {ent['name']!r} checksum mismatch "
                f"(corrupted shard)")
        arr = np.frombuffer(raw, dtype=np.dtype(ent["dtype"]))
        out[ent["name"]] = arr.reshape(ent["shape"])
    if want is not None and want - set(out):
        raise KeyError(f"shard has no column(s) {sorted(want - set(out))}")
    return out, header.get("meta", {})


def read_shard(path: str, *, columns: Optional[list[str]] = None
               ) -> tuple[dict[str, np.ndarray], dict]:
    """Read + decode one shard file."""
    with open(path, "rb") as f:
        return decode_shard(f.read(), columns=columns)
