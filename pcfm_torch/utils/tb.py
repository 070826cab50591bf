"""Dependency-free TensorBoard scalar writer — a copy of pcfm/utils/tb.py.

The reference logs only via prints/tqdm (SURVEY §5 "metrics/logging");
pcfm already writes ``metrics.jsonl``.  This adds an optional
TensorBoard-compatible sink (``--tensorboard``) without depending on
tensorflow/tensorboardX: event files are TFRecord-framed ``Event``
protobufs, and the scalar subset used here needs only three proto
messages, hand-encoded below.

Wire format (public, stable since TF 1.x):
  record  = uint64le(len) crc32c_masked(len_bytes)
            data          crc32c_masked(data)
  Event   = 1:double wall_time, 2:int64 step,
            3:string file_version | 5:Summary summary
  Summary = repeated 1:Value;  Value = 1:string tag, 2:float simple_value
"""
from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78                      # Castagnoli, reflected
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _str_field(field: int, s: bytes) -> bytes:
    return _key(field, 2) + _varint(len(s)) + s


def _scalar_value(tag: str, value: float) -> bytes:
    v = _str_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)
    return _str_field(1, v)                    # Summary.value (field 1)


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF) + body)


class SummaryWriter:
    """Minimal tf.summary.SummaryWriter equivalent (scalars only)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{time.time():.6f}.{host}")
        self._f = open(self.path, "ab")
        # header record: file_version (Event field 3)
        self._write(_event(time.time(), 0,
                           _str_field(3, b"brain.Event:2")))

    def _write(self, payload: bytes):
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None):
        summary = _str_field(5, _scalar_value(tag, float(value)))
        self._write(_event(wall_time if wall_time is not None
                           else time.time(), int(step), summary))

    def add_scalars(self, scalars: dict, step: int):
        wt = time.time()
        body = b"".join(_scalar_value(t, float(v))
                        for t, v in scalars.items())
        self._write(_event(wt, int(step), _str_field(5, body)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


# --------------------------------------------------- reader (for tests)
def read_events(path: str):
    """Parse an event file back into [(step, {tag: value})] — used by the
    round-trip test and handy for quick inspection without TensorBoard."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (ln,) = struct.unpack("<Q", hdr)
            (crc_h,) = struct.unpack("<I", f.read(4))
            if crc_h != _masked_crc(hdr):
                raise ValueError("corrupt length crc")
            data = f.read(ln)
            (crc_d,) = struct.unpack("<I", f.read(4))
            if crc_d != _masked_crc(data):
                raise ValueError("corrupt data crc")
            step, scalars = _parse_event(data)
            if scalars:
                out.append((step, scalars))
    return out


def _read_varint(data: bytes, i: int):
    n = s = 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << s
        if not b & 0x80:
            return n, i
        s += 7


def _parse_event(data: bytes):
    i, step, scalars = 0, 0, {}
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 0:
            v, i = _read_varint(data, i)
            if field == 2:
                step = v
        elif wire == 2:
            ln, i = _read_varint(data, i)
            if field == 5:
                scalars.update(_parse_summary(data[i:i + ln]))
            i += ln
    return step, scalars


def _parse_summary(data: bytes):
    i, out = 0, {}
    while i < len(data):
        key, i = _read_varint(data, i)
        ln, i = _read_varint(data, i)
        if key >> 3 == 1:
            out.update(_parse_value(data[i:i + ln]))
        i += ln
    return out


def _parse_value(data: bytes):
    i, tag, val = 0, None, None
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln, i = _read_varint(data, i)
            if field == 1:
                tag = data[i:i + ln].decode()
            i += ln
        elif wire == 5:
            if field == 2:
                (val,) = struct.unpack("<f", data[i:i + 4])
            i += 4
        elif wire == 0:
            _, i = _read_varint(data, i)
        elif wire == 1:
            i += 8
    return {tag: val} if tag is not None and val is not None else {}
