"""Dependency-free TensorBoard event-file writer.

The port's copy of ``dreammat_tpu/utils/tboard.py``: no tensorboard or
tensorflow package is needed, since scalar events are hand-encoded. A
tfevents file is a TFRecord stream

    [len u64le][masked-crc32c(len) u32le][payload][masked-crc32c(payload) u32le]

whose payloads are ``Event`` protobufs. Only the fields TensorBoard's
scalar dashboard reads are emitted (Event.wall_time=1 double,
Event.step=2 int64, Event.summary=5 -> Summary.value=1 ->
Value{tag=1 string, simple_value=2 float}; plus the conventional
file_version event), so the wire encoding is ~40 lines instead of a
protobuf dependency. Files are named ``events.out.tfevents.<ts>.<host>``
and load in a stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Any, Dict


def _crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delimited(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int | None = None,
                 scalars: Dict[str, float] | None = None,
                 file_version: str | None = None) -> bytes:
    """Wire-encode one Event protobuf."""
    msg = _field(1, 1) + struct.pack("<d", wall_time)  # wall_time: double
    if step is not None:
        msg += _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        msg += _len_delimited(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars.items():
            val = (_len_delimited(1, tag.encode())
                   + _field(2, 5) + struct.pack("<f", float(value)))
            summary += _len_delimited(1, val)
        msg += _len_delimited(5, summary)
    return msg


def tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


class TensorBoardLogger:
    """Scalar-only TensorBoard writer with the reference's logger slot."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        host = socket.gethostname() or "localhost"
        self.path = os.path.join(
            out_dir, f"events.out.tfevents.{int(time.time())}.{host}")
        with open(self.path, "wb") as f:
            f.write(tfrecord(encode_event(time.time(),
                                          file_version="brain.Event:2")))

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        rec = tfrecord(encode_event(
            time.time(), step=step,
            scalars={k: float(v) for k, v in metrics.items()}))
        with open(self.path, "ab") as f:
            f.write(rec)
