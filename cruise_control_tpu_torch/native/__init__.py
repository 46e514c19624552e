"""Native (C++) host-runtime components, ctypes-loaded.

The device work is the package's CUDA kernels; the host runtime around it
keeps Python out of per-record hot loops with small C++ code:

  serde.cpp — one-pass columnar batch deserialization of the
  metrics-reporter wire stream with topic interning (the service-side
  analog of the reference's JVM sampler loop,
  CruiseControlMetricsReporterSampler.java:101).

The shared library is built with g++ on first use into the package's
`_build/` directory (beside the CUDA kernels' libraries, never next to the
sources); its file name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  Every entry point
has a pure-Python path with the same semantics, taken when the toolchain
is missing or when the caller asks for it (`force_python=True`);
`native_calls()` counts the batches the C++ path decoded, so a caller can
tell which of the two ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "serde.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False
_native_calls = 0


def library_path() -> Path:
    h = hashlib.sha1(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"ccnative-{h.hexdigest()[:12]}.so"


def _load() -> ctypes.CDLL | None:
    """Build (if missing) and load the shared library; None if the
    toolchain is unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            fn = lib.ccn_batch_deserialize
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ]
            crc = lib.ccn_crc32c
            crc.restype = ctypes.c_uint32
            crc.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_uint32]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib_failed = True
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_calls() -> int:
    """Batches decoded by the C++ path in this process."""
    return _native_calls


def crc32c_native(data: bytes, crc: int = 0) -> int | None:
    """Hardware-speed CRC-32C, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return int(lib.ccn_crc32c(data, len(data), crc))


class MetricBatch:
    """Columnar view of a deserialized metric batch."""

    __slots__ = (
        "class_ids", "metric_types", "times_ms", "broker_ids", "values",
        "partitions", "topic_ids", "topics",
    )

    def __init__(self, class_ids, metric_types, times_ms, broker_ids, values,
                 partitions, topic_ids, topics):
        self.class_ids = class_ids      # u8[N] 0=broker 1=topic 2=partition
        self.metric_types = metric_types  # u16[N]
        self.times_ms = times_ms        # i64[N]
        self.broker_ids = broker_ids    # i32[N]
        self.values = values            # f64[N]
        self.partitions = partitions    # i32[N], -1 for non-partition records
        self.topic_ids = topic_ids      # i32[N], -1 for broker records
        self.topics = topics            # list[str], indexed by topic_ids

    def __len__(self) -> int:
        return len(self.values)


def frame_records(records: list[bytes]) -> bytes:
    """u32-length-prefixed concatenation (the batch wire framing)."""
    out = bytearray()
    for r in records:
        out += len(r).to_bytes(4, "little")
        out += r
    return bytes(out)


def batch_deserialize(framed: bytes, *, force_python: bool = False) -> MetricBatch:
    """Parse a framed record batch into columns (native, else Python)."""
    lib = None if force_python else _load()
    if lib is None:
        return _batch_deserialize_py(framed)
    n = len(framed)
    max_records = max(1, n // 28)  # 24B head + 4B frame minimum
    max_topics = max(16, max_records)
    class_ids = np.empty(max_records, np.uint8)
    mtypes = np.empty(max_records, np.uint16)
    times = np.empty(max_records, np.int64)
    brokers = np.empty(max_records, np.int32)
    values = np.empty(max_records, np.float64)
    partitions = np.empty(max_records, np.int32)
    topic_ids = np.empty(max_records, np.int32)
    topic_offsets = np.empty(max_topics, np.int64)
    topic_lens = np.empty(max_topics, np.int32)
    n_topics = ctypes.c_long(0)
    count = lib.ccn_batch_deserialize(
        framed, n,
        class_ids.ctypes.data, mtypes.ctypes.data, times.ctypes.data,
        brokers.ctypes.data, values.ctypes.data, partitions.ctypes.data,
        topic_ids.ctypes.data, topic_offsets.ctypes.data,
        topic_lens.ctypes.data, max_topics, ctypes.byref(n_topics), max_records,
    )
    if count < 0:
        raise ValueError(f"malformed metric batch (native rc={count})")
    global _native_calls
    with _lock:
        _native_calls += 1
    topics = [
        framed[topic_offsets[i]: topic_offsets[i] + topic_lens[i]].decode()
        for i in range(n_topics.value)
    ]
    return MetricBatch(
        class_ids[:count], mtypes[:count], times[:count], brokers[:count],
        values[:count], partitions[:count], topic_ids[:count], topics,
    )


def _batch_deserialize_py(framed: bytes) -> MetricBatch:
    """Pure-Python fallback with identical semantics."""
    import struct

    head = struct.Struct("<BBHqid")
    off = 0
    n = len(framed)
    cols: list[tuple] = []
    topics: list[str] = []
    interned: dict[str, int] = {}
    while off + 4 <= n:
        (rec_len,) = struct.unpack_from("<I", framed, off)
        off += 4
        if rec_len < 24 or off + rec_len > n:
            raise ValueError("malformed metric batch")
        cls, _ver, mt, tms, bid, val = head.unpack_from(framed, off)
        tid, part = -1, -1
        if cls != 0:
            # mirror the native decoder's bounds checks (serde.cpp returns -1)
            if rec_len < 26:
                raise ValueError("malformed metric batch")
            (tl,) = struct.unpack_from("<H", framed, off + 24)
            if 26 + tl > rec_len or (cls == 2 and 26 + tl + 4 > rec_len):
                raise ValueError("malformed metric batch")
            topic = framed[off + 26: off + 26 + tl].decode()
            tid = interned.get(topic)
            if tid is None:
                tid = interned[topic] = len(topics)
                topics.append(topic)
            if cls == 2:
                (part,) = struct.unpack_from("<i", framed, off + 26 + tl)
        cols.append((cls, mt, tms, bid, val, part, tid))
        off += rec_len
    if off != n:
        raise ValueError("malformed metric batch")
    if not cols:
        z = np.zeros(0)
        return MetricBatch(
            z.astype(np.uint8), z.astype(np.uint16), z.astype(np.int64),
            z.astype(np.int32), z.astype(np.float64), z.astype(np.int32),
            z.astype(np.int32), [],
        )
    arr = list(zip(*cols))
    return MetricBatch(
        np.asarray(arr[0], np.uint8), np.asarray(arr[1], np.uint16),
        np.asarray(arr[2], np.int64), np.asarray(arr[3], np.int32),
        np.asarray(arr[4], np.float64), np.asarray(arr[5], np.int32),
        np.asarray(arr[6], np.int32), topics,
    )
