"""Minimal TensorBoard scalar event writer (no TF dependency).

The reference logs per-iteration scalar groups through
torch.utils.tensorboard (reference train.py:20, 154, 269, 461, 612 —
though its `writer.close()` inside the epoch loop truncates everything
after epoch 0, a bug we do NOT reproduce). This writer emits the
TFRecord/Event wire format directly — [len][crc(len)][payload]
[crc(payload)] with masked CRC32C, payload = hand-encoded Event proto
(wall_time=1:double, step=2:int64, summary=5 { value { tag=1:string,
simple_value=2:float } }) — so standard TensorBoard reads the files.

Scalars are additionally mirrored to a jsonl side-car, which is what
the framework's own tooling consumes. A byte-level copy of the JAX
package's `train/tensorboard.py`.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_event(wall_time: float, step: int, scalars: dict[str, float]) -> bytes:
    values = b""
    for tag, val in scalars.items():
        t = tag.encode()
        v = (
            _field(1, 2) + _varint(len(t)) + t
            + _field(2, 5) + struct.pack("<f", float(val))
        )
        values += _field(1, 2) + _varint(len(v)) + v
    event = (
        _field(1, 1) + struct.pack("<d", wall_time)
        + _field(2, 0) + _varint(step)
        + _field(5, 2) + _varint(len(values)) + values
    )
    return event


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class SummaryWriter:
    """Scalar-only TensorBoard writer + jsonl mirror."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._path = os.path.join(log_dir, fname)
        self._jsonl = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self._path, "ab")
        # file-version event
        version = _field(1, 1) + struct.pack("<d", time.time())
        version += _field(3, 2) + _varint(len(b"brain.Event:2")) + b"brain.Event:2"
        self._f.write(_record(version))
        self._f.flush()

    def add_scalars(self, group: str, scalars: dict[str, float], step: int):
        now = time.time()
        tagged = {f"{group}/{k}": v for k, v in scalars.items()}
        self._f.write(_record(_encode_event(now, step, tagged)))
        self._f.flush()
        with open(self._jsonl, "a") as jf:
            jf.write(json.dumps({"step": step, **tagged}) + "\n")

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars(tag.rsplit("/", 1)[0] if "/" in tag else "scalar",
                         {tag.rsplit("/", 1)[-1]: value}, step)

    def close(self):
        self._f.close()
