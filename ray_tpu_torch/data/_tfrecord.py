"""Minimal TFRecord + tf.train.Example codec, no tensorflow dependency.

TFRecord framing: <len u64le><masked crc32c of len><data><masked crc32c
of data>. Example payloads are protobuf; this parses just the
Features/Feature subset of the schema (bytes_list / float_list /
int64_list) with hand-rolled wire decoding. Reference behavior:
python/ray/data/_internal/datasource/tfrecords_datasource.py.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

# ------------------------------------------------------------------ crc32c

_CRC_TABLE: List[int] = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf wire core

def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes) -> Any:
    for field, _, val in _fields(buf):
        if field == 1:  # bytes_list
            out = [v for f, _, v in _fields(val) if f == 1]
            return out[0] if len(out) == 1 else out
        if field == 2:  # float_list
            floats: List[float] = []
            for f, wire, v in _fields(val):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:
                    floats.append(struct.unpack("<f", v)[0])
            return floats[0] if len(floats) == 1 else floats
        if field == 3:  # int64_list
            def signed(x: int) -> int:
                # varints carry two's-complement int64
                return x - (1 << 64) if x >= 1 << 63 else x

            ints: List[int] = []
            for f, wire, v in _fields(val):
                if f != 1:
                    continue
                if wire == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(signed(x))
                else:
                    ints.append(signed(v))
            return ints[0] if len(ints) == 1 else ints
    return None


def parse_example(buf: bytes) -> Dict[str, Any]:
    row: Dict[str, Any] = {}
    for field, _, val in _fields(buf):
        if field != 1:  # Example.features
            continue
        for f, _, entry in _fields(val):
            if f != 1:  # Features.feature map entry
                continue
            key = None
            feat = None
            for ef, _, ev in _fields(entry):
                if ef == 1:
                    key = ev.decode()
                elif ef == 2:
                    feat = _parse_feature(ev)
            if key is not None:
                row[key] = feat
    return row


def read_examples(path: str) -> Iterator[Dict[str, Any]]:
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return
            (length,) = struct.unpack("<Q", hdr[:8])
            data = f.read(length)
            f.read(4)  # data crc (not validated, like the reference default)
            yield parse_example(data)


# ------------------------------------------------------------------ writing

def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_feature(value: Any) -> bytes:
    vals = value if isinstance(value, (list, tuple)) else [value]
    if all(isinstance(v, (bytes, str)) for v in vals):
        inner = b"".join(
            _len_delim(1, v.encode() if isinstance(v, str) else v) for v in vals
        )
        return _len_delim(1, inner)  # bytes_list
    if all(isinstance(v, (int,)) for v in vals):
        packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in vals)
        return _len_delim(3, _len_delim(1, packed))  # int64_list packed
    inner = struct.pack(f"<{len(vals)}f", *[float(v) for v in vals])
    return _len_delim(2, _len_delim(1, inner))  # float_list packed


def encode_example(row: Dict[str, Any]) -> bytes:
    entries = b""
    for key, value in row.items():
        entry = _len_delim(1, key.encode()) + _len_delim(2, _encode_feature(value))
        entries += _len_delim(1, entry)
    return _len_delim(1, entries)  # Example.features


def write_examples(path: str, rows) -> None:
    with open(path, "wb") as f:
        for row in rows:
            data = encode_example(row)
            hdr = struct.pack("<Q", len(data))
            f.write(hdr)
            f.write(struct.pack("<I", masked_crc(hdr)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc(data)))
