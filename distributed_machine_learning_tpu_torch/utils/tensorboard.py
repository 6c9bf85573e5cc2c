"""Dependency-free TensorBoard scalar logging.

Port of ``distributed_machine_learning_tpu/utils/tensorboard.py``, kept as
the port's own copy (the JAX package's ``__init__`` imports jax).  It is
standard library only and writes the same bytes.

A TensorBoard event file is a TFRecord stream of serialized ``Event``
protobufs.  Both formats are tiny and stable, so they are encoded by hand:

* TFRecord framing: ``uint64 length | masked crc32c(length) | payload |
  masked crc32c(payload)``, CRC-32C (Castagnoli) with TensorFlow's mask
  ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``.
* ``Event`` proto (tensorflow/core/util/event.proto): field 1 ``wall_time``
  (double), field 2 ``step`` (int64), field 3 ``file_version`` (string,
  first record only), field 5 ``summary`` (message).
* ``Summary`` proto: repeated field 1 ``value``; ``Summary.Value``: field 1
  ``tag`` (string), field 2 ``simple_value`` (float).

Only scalar summaries are emitted.  :func:`read_events` reads them back,
so tests round-trip the format without TensorBoard installed.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

# --------------------------------------------------------------------------
# CRC-32C (Castagnoli), reflected polynomial 0x82F63B78 — table-driven.
# --------------------------------------------------------------------------

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# Minimal protobuf wire encoding (varint / length-delimited / fixed).
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _encode_event(wall_time: float, step: Optional[int] = None,
                  file_version: Optional[str] = None,
                  scalars: Optional[List[Tuple[str, float]]] = None) -> bytes:
    ev = _field_double(1, wall_time)
    if step is not None:
        ev += _field_varint(2, step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(
                1, _field_bytes(1, tag.encode()) + _field_float(2, float(v))
            )
            for tag, v in scalars
        )
        ev += _field_bytes(5, summary)
    return ev


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------


class SummaryWriter:
    """Append-only scalar event writer for one TensorBoard run directory.

    Thread-safe (the tune runner may report from its event loop while a
    caller flushes). The file carries the conventional
    ``events.out.tfevents.<ts>.<host>`` name TensorBoard globs for.
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        # TensorBoard ignores files whose first record is not this version
        # stamp.
        self._write(_encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(_tfrecord(event))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        with self._lock:
            if self._f.closed:
                return
            self._write(
                _encode_event(
                    wall_time if wall_time is not None else time.time(),
                    step=int(step), scalars=[(tag, value)],
                )
            )

    def add_scalars(self, scalars: List[Tuple[str, float]], step: int,
                    wall_time: Optional[float] = None) -> None:
        """All tags in ONE Event record (one timestamp, one fsync unit)."""
        with self._lock:
            if self._f.closed:
                return
            self._write(
                _encode_event(
                    wall_time if wall_time is not None else time.time(),
                    step=int(step), scalars=list(scalars),
                )
            )

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


# --------------------------------------------------------------------------
# Reader (tests + offline analysis without TensorBoard installed)
# --------------------------------------------------------------------------


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, raw_payload) triples."""
    pos = 0
    while pos < len(buf):
        key, pos = _decode_varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _decode_varint(buf, pos)
            yield num, wt, _varint(val)
        elif wt == 1:
            yield num, wt, buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _decode_varint(buf, pos)
            yield num, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            yield num, wt, buf[pos:pos + 4]
            pos += 4
        else:  # pragma: no cover - groups don't appear in event files
            raise ValueError(f"unsupported wire type {wt}")


def read_events(path: str, verify_crc: bool = True):
    """Parse an event file -> list of {wall_time, step, scalars:{tag: val}}.

    Raises ``ValueError`` on CRC mismatch when ``verify_crc`` (the framing
    is exactly what TensorBoard checks, so a pass here means TB loads it).
    """
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        payload = data[pos + 12: pos + 12 + length]
        (pay_crc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if verify_crc:
            if _masked_crc(data[pos: pos + 8]) != len_crc:
                raise ValueError(f"length CRC mismatch at offset {pos}")
            if _masked_crc(payload) != pay_crc:
                raise ValueError(f"payload CRC mismatch at offset {pos}")
        pos += 12 + length + 4

        record = {"wall_time": None, "step": 0, "scalars": {},
                  "file_version": None}
        for num, _wt, raw in _parse_fields(payload):
            if num == 1:
                record["wall_time"] = struct.unpack("<d", raw)[0]
            elif num == 2:
                record["step"], _ = _decode_varint(raw, 0)
            elif num == 3:
                record["file_version"] = raw.decode()
            elif num == 5:
                for vnum, _vwt, vraw in _parse_fields(raw):
                    if vnum != 1:
                        continue
                    tag, val = None, None
                    for fnum, _fwt, fraw in _parse_fields(vraw):
                        if fnum == 1:
                            tag = fraw.decode()
                        elif fnum == 2:
                            val = struct.unpack("<f", fraw)[0]
                    if tag is not None and val is not None:
                        record["scalars"][tag] = val
        out.append(record)
    return out
