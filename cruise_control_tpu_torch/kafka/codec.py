"""Kafka wire-format primitives + declarative schemas.

Implements both encodings of the Kafka protocol (public spec,
kafka.apache.org/protocol):
  * classic: big-endian fixed-width ints, INT16-length strings,
    INT32-length arrays (null = -1);
  * compact/flexible (KIP-482): unsigned-varint length+1 strings/arrays and
    tagged-field buffers.

A schema is a list of (field_name, type) pairs; `Struct.encode` /
`Struct.decode` map dicts <-> bytes.  Types are tiny singletons with
`write(out: bytearray, v)` and `read(buf, off) -> (v, off)`.
"""

from __future__ import annotations

import struct


class CodecError(Exception):
    pass


# ---------------------------------------------------------------- varints


def write_uvarint(out: bytearray, v: int) -> None:
    if v < 0:
        raise CodecError(f"uvarint must be >= 0, got {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_uvarint(buf, off: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if off >= len(buf):
            raise CodecError("truncated uvarint")
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
        if shift > 63:
            raise CodecError("uvarint too long")


# ---------------------------------------------------------------- primitives


class _Fixed:
    def __init__(self, fmt: str):
        self._s = struct.Struct(fmt)

    def write(self, out: bytearray, v) -> None:
        out += self._s.pack(v)

    def read(self, buf, off: int):
        (v,) = self._s.unpack_from(buf, off)
        return v, off + self._s.size


Int8 = _Fixed(">b")
Int16 = _Fixed(">h")
Int32 = _Fixed(">i")
Int64 = _Fixed(">q")


class _Boolean:
    def write(self, out: bytearray, v) -> None:
        out.append(1 if v else 0)

    def read(self, buf, off: int):
        return buf[off] != 0, off + 1


Boolean = _Boolean()


class _String:
    """Classic STRING / NULLABLE_STRING (INT16 length, -1 = null)."""

    def __init__(self, nullable: bool = False):
        self.nullable = nullable

    def write(self, out: bytearray, v) -> None:
        if v is None:
            if not self.nullable:
                raise CodecError("null for non-nullable string")
            Int16.write(out, -1)
            return
        raw = v.encode()
        Int16.write(out, len(raw))
        out += raw

    def read(self, buf, off: int):
        n, off = Int16.read(buf, off)
        if n == -1:
            return None, off
        return bytes(buf[off: off + n]).decode(), off + n


String = _String()
NullableString = _String(nullable=True)


class _CompactString:
    """COMPACT_STRING / COMPACT_NULLABLE_STRING (uvarint length+1, 0 = null)."""

    def __init__(self, nullable: bool = False):
        self.nullable = nullable

    def write(self, out: bytearray, v) -> None:
        if v is None:
            if not self.nullable:
                raise CodecError("null for non-nullable compact string")
            write_uvarint(out, 0)
            return
        raw = v.encode()
        write_uvarint(out, len(raw) + 1)
        out += raw

    def read(self, buf, off: int):
        n, off = read_uvarint(buf, off)
        if n == 0:
            return None, off
        n -= 1
        return bytes(buf[off: off + n]).decode(), off + n


CompactString = _CompactString()
CompactNullableString = _CompactString(nullable=True)


class _Bytes:
    """Classic BYTES / NULLABLE_BYTES (INT32 length, -1 = null)."""

    def __init__(self, nullable: bool = False):
        self.nullable = nullable

    def write(self, out: bytearray, v) -> None:
        if v is None:
            if not self.nullable:
                raise CodecError("null for non-nullable bytes")
            Int32.write(out, -1)
            return
        Int32.write(out, len(v))
        out += v

    def read(self, buf, off: int):
        n, off = Int32.read(buf, off)
        if n == -1:
            return None, off
        return bytes(buf[off: off + n]), off + n


Bytes = _Bytes()
NullableBytes = _Bytes(nullable=True)


class Array:
    """Classic ARRAY (INT32 count, -1 = null)."""

    def __init__(self, inner, nullable: bool = False):
        self.inner = inner
        self.nullable = nullable

    def write(self, out: bytearray, v) -> None:
        if v is None:
            if not self.nullable:
                raise CodecError("null for non-nullable array")
            Int32.write(out, -1)
            return
        Int32.write(out, len(v))
        for item in v:
            self.inner.write(out, item)

    def read(self, buf, off: int):
        n, off = Int32.read(buf, off)
        if n == -1:
            return None, off
        items = []
        for _ in range(n):
            item, off = self.inner.read(buf, off)
            items.append(item)
        return items, off


class CompactArray:
    """COMPACT_ARRAY (uvarint count+1, 0 = null)."""

    def __init__(self, inner, nullable: bool = False):
        self.inner = inner
        self.nullable = nullable

    def write(self, out: bytearray, v) -> None:
        if v is None:
            if not self.nullable:
                raise CodecError("null for non-nullable compact array")
            write_uvarint(out, 0)
            return
        write_uvarint(out, len(v) + 1)
        for item in v:
            self.inner.write(out, item)

    def read(self, buf, off: int):
        n, off = read_uvarint(buf, off)
        if n == 0:
            return None, off
        items = []
        for _ in range(n - 1):
            item, off = self.inner.read(buf, off)
            items.append(item)
        return items, off


class _TagBuffer:
    """Flexible-version tagged fields; we never send or interpret any."""

    def write(self, out: bytearray, v=None) -> None:
        write_uvarint(out, 0)

    def read(self, buf, off: int):
        n, off = read_uvarint(buf, off)
        for _ in range(n):
            _tag, off = read_uvarint(buf, off)
            size, off = read_uvarint(buf, off)
            off += size  # skip unknown tagged field
        return None, off


TagBuffer = _TagBuffer()


class Struct:
    """Named-field record: encodes/decodes dicts by schema order.

    Fields named "_tags" (TagBuffer) are emitted/consumed but not surfaced
    in the dict.
    """

    def __init__(self, *fields: tuple[str, object]):
        self.fields = fields

    def write(self, out: bytearray, v: dict) -> None:
        for name, typ in self.fields:
            if name.startswith("_tags"):
                typ.write(out)
            else:
                typ.write(out, v[name])

    def read(self, buf, off: int):
        out = {}
        for name, typ in self.fields:
            val, off = typ.read(buf, off)
            if not name.startswith("_tags"):
                out[name] = val
        return out, off

    def encode(self, v: dict) -> bytes:
        out = bytearray()
        self.write(out, v)
        return bytes(out)

    def decode(self, buf) -> dict:
        v, off = self.read(buf, 0)
        if off != len(buf):
            raise CodecError(f"{len(buf) - off} trailing bytes after decode")
        return v
