"""Kafka record-batch v2 (magic 2) encode/decode.

The metrics-reporter stream rides normal Kafka topics
(`__CruiseControlMetrics`, reference CruiseControlMetricsReporter.java;
sample-store topics, KafkaSampleStore.java:117-128), so the produce/fetch
path needs the message format: one RecordBatch per produce, varint-encoded
records inside, CRC-32C (Castagnoli) over the post-CRC bytes.

Layout (public spec, kafka.apache.org/documentation/#recordbatch):

  baseOffset i64 | batchLength i32 | partitionLeaderEpoch i32 | magic i8 |
  crc u32 | attributes i16 | lastOffsetDelta i32 | baseTimestamp i64 |
  maxTimestamp i64 | producerId i64 | producerEpoch i16 | baseSequence i32 |
  recordCount i32 | records...

  record: length zigzag | attributes i8 | timestampDelta zigzag |
  offsetDelta zigzag | keyLen zigzag (-1 null) | key | valueLen zigzag |
  value | headerCount zigzag (0)

No compression (attributes 0) — metric records are tiny and the reporter
defaults to uncompressed.
"""

from __future__ import annotations

import dataclasses
import struct

# ------------------------------------------------------------------ crc32c

_CRC32C_POLY = 0x82F63B78
_crc_table: list[int] = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _crc_table.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), the record-batch checksum.

    Uses the native slice-by-8 kernel when available (fetch payloads are
    multi-MB; a per-byte Python loop would dominate the consume path the
    native columnar decoder exists to accelerate)."""
    from cruise_control_tpu_torch.native import crc32c_native

    fast = crc32c_native(data, crc)
    if fast is not None:
        return fast
    crc = ~crc & 0xFFFFFFFF
    for b in data:
        crc = _crc_table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF


# ----------------------------------------------------------- zigzag varint


def write_zigzag(out: bytearray, v: int) -> None:
    z = (v << 1) ^ (v >> 63)
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_zigzag(buf, off: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (result >> 1) ^ -(result & 1), off


# ------------------------------------------------------------------ batches


@dataclasses.dataclass(frozen=True)
class Record:
    offset: int
    timestamp_ms: int
    key: bytes | None
    value: bytes


_HEAD = struct.Struct(">qiibIhiqqqhii")
#        baseOffset batchLen leaderEpoch magic crc attrs lastOffsetDelta
#        baseTs maxTs producerId producerEpoch baseSeq recordCount


def encode_batch(
    records: list[tuple[bytes | None, bytes]],
    *,
    base_offset: int = 0,
    base_timestamp_ms: int = 0,
) -> bytes:
    """Encode [(key, value)] as one uncompressed v2 batch."""
    if not records:
        raise ValueError("empty batch")
    body = bytearray()
    for i, (key, value) in enumerate(records):
        rec = bytearray()
        rec.append(0)  # attributes
        write_zigzag(rec, 0)  # timestampDelta
        write_zigzag(rec, i)  # offsetDelta
        if key is None:
            write_zigzag(rec, -1)
        else:
            write_zigzag(rec, len(key))
            rec += key
        write_zigzag(rec, len(value))
        rec += value
        write_zigzag(rec, 0)  # headers
        write_zigzag(body, len(rec))
        body += rec

    n = len(records)
    # post-crc section: attributes .. records
    post = struct.pack(
        ">hiqqqhii",
        0,                      # attributes (no compression)
        n - 1,                  # lastOffsetDelta
        base_timestamp_ms,      # baseTimestamp
        base_timestamp_ms,      # maxTimestamp
        -1, -1, -1,             # producerId/Epoch, baseSequence
        n,
    ) + bytes(body)
    crc = crc32c(post)
    # batchLength counts bytes after the batchLength field itself
    batch_len = 4 + 1 + 4 + len(post)  # leaderEpoch + magic + crc + post
    return (
        struct.pack(">qii", base_offset, batch_len, -1)
        + b"\x02"  # magic
        + struct.pack(">I", crc)
        + post
    )


def decode_batches(buf: bytes, *, verify_crc: bool = True) -> list[Record]:
    """Decode a concatenation of v2 batches (a fetched record set).

    A trailing partial batch (normal in fetch responses) is ignored.
    """
    out: list[Record] = []
    off = 0
    n = len(buf)
    while off + 12 <= n:
        base_offset, batch_len = struct.unpack_from(">qi", buf, off)
        total = 12 + batch_len
        if off + total > n:
            break  # partial trailing batch
        magic = buf[off + 16]
        if magic != 2:
            raise ValueError(f"unsupported magic {magic}")
        (crc,) = struct.unpack_from(">I", buf, off + 17)
        post = buf[off + 21: off + total]
        if verify_crc and crc32c(post) != crc:
            raise ValueError("record batch CRC mismatch")
        (attrs, _last_delta, base_ts, _max_ts, _pid, _pepoch, _bseq, count) = (
            struct.unpack_from(">hiqqqhii", post, 0)
        )
        if attrs & 0x07:
            raise ValueError("compressed batches not supported")
        p = 40  # past the fixed post-crc header (2+4+8+8+8+2+4+4)
        for _ in range(count):
            rec_len, p = read_zigzag(post, p)
            rec_end = p + rec_len
            p += 1  # record attributes
            ts_delta, p = read_zigzag(post, p)
            off_delta, p = read_zigzag(post, p)
            key_len, p = read_zigzag(post, p)
            key = None
            if key_len >= 0:
                key = bytes(post[p: p + key_len])
                p += key_len
            val_len, p = read_zigzag(post, p)
            # -1 = null value (tombstone on a compacted topic — the
            # reference's sample-store topics are compacted)
            value = b""
            if val_len >= 0:
                value = bytes(post[p: p + val_len])
                p += val_len
            hdr_count, p = read_zigzag(post, p)
            for _h in range(hdr_count):
                klen, p = read_zigzag(post, p)
                p += klen
                vlen, p = read_zigzag(post, p)
                p += max(vlen, 0)
            if p != rec_end:
                raise ValueError("record length mismatch")
            out.append(
                Record(
                    offset=base_offset + off_delta,
                    timestamp_ms=base_ts + ts_delta,
                    key=key,
                    value=value,
                )
            )
        off += total
    return out
