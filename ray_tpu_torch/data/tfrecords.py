"""TFRecord IO without TensorFlow: record framing + tf.train.Example codec.

Reference: data/datasource/tfrecords_datasource.py (which imports TF). The
sealed image has no tensorflow, and pulling a framework for a file format
would be backwards — the TFRecord container and the Example protobuf wire
format are both small, stable specs, implemented here directly:

  record  = u64le length | u32le masked_crc32c(length) | data
            | u32le masked_crc32c(data)
  Example = protobuf message { Features features = 1 }
  Features= { map<string, Feature> feature = 1 }
  Feature = { oneof: BytesList=1, FloatList=2, Int64List=3 }

CRCs use crc32c (Castagnoli) with TFRecord's rotate+magic masking; reads
verify by default (set verify=False to skip the checksum cost on trusted
files). Columns decode to numpy: int64/float32 lists (squeezed to scalars
when every row has one element) and object arrays of bytes.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

# -- crc32c (Castagnoli, table-driven) ---------------------------------------

_CRC_TABLE: Optional[List[int]] = None


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # reflected Castagnoli
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -- record framing -----------------------------------------------------------


def write_records(path: str, payloads: Iterator[bytes]) -> int:
    """Append-write framed records; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
            n += 1
    return n


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError(f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = f.read(4)
            if len(hcrc_raw) != 4:
                raise ValueError(f"truncated header crc in {path}")
            data = f.read(length)
            if len(data) != length:
                raise ValueError(f"truncated record body in {path}")
            dcrc_raw = f.read(4)
            if len(dcrc_raw) != 4:
                raise ValueError(f"truncated data crc in {path}")
            if verify:
                if _masked_crc(header) != struct.unpack("<I", hcrc_raw)[0]:
                    raise ValueError(f"header crc mismatch in {path}")
                if _masked_crc(data) != struct.unpack("<I", dcrc_raw)[0]:
                    raise ValueError(f"data crc mismatch in {path}")
            yield data


# -- protobuf wire format (just what Example needs) ---------------------------


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(data: bytes, pos: int) -> tuple:
    result = 0
    shift = 0
    while True:
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload


def encode_example(features: Dict[str, object]) -> bytes:
    """Encode {name: value} into a tf.train.Example payload. Values:
    bytes/str (BytesList), float/list-of-float (FloatList), int/list-of-int
    (Int64List), or 1-D numpy arrays of those."""
    feat_map = bytearray()
    for name, value in features.items():
        feature = bytearray()
        if isinstance(value, (bytes, str)):
            value = [value]
        arr = np.asarray(value)
        if arr.dtype.kind in ("U", "S", "O") or isinstance(
            arr.flat[0] if arr.size else b"", (bytes, str)
        ):
            sub = bytearray()  # BytesList { repeated bytes value = 1 }
            for item in arr.ravel():
                raw = item.encode() if isinstance(item, str) else bytes(item)
                _write_len_delimited(sub, 1, raw)
            body = bytearray()
            _write_len_delimited(body, 1, bytes(sub))  # Feature.bytes_list=1
            feature = body
        elif arr.dtype.kind == "f":
            sub = bytearray()  # FloatList { repeated float value = 1 [packed] }
            packed = np.asarray(arr, dtype="<f4").tobytes()
            _write_len_delimited(sub, 1, packed)
            body = bytearray()
            _write_len_delimited(body, 2, bytes(sub))  # Feature.float_list=2
            feature = body
        elif arr.dtype.kind in ("i", "u", "b"):
            sub = bytearray()  # Int64List { repeated int64 value = 1 [packed] }
            ints = bytearray()
            for item in np.asarray(arr, dtype=np.int64).ravel():
                _write_varint(ints, int(item) & 0xFFFFFFFFFFFFFFFF)
            _write_len_delimited(sub, 1, bytes(ints))
            body = bytearray()
            _write_len_delimited(body, 3, bytes(sub))  # Feature.int64_list=3
            feature = body
        else:
            raise TypeError(f"unsupported feature type for {name!r}: {arr.dtype}")
        entry = bytearray()  # map entry { key=1, value=2 }
        _write_len_delimited(entry, 1, name.encode())
        _write_len_delimited(entry, 2, bytes(feature))
        _write_len_delimited(feat_map, 1, bytes(entry))  # Features.feature=1
    example = bytearray()
    _write_len_delimited(example, 1, bytes(feat_map))  # Example.features=1
    return bytes(example)


def _parse_len_delimited_fields(data: bytes) -> Iterator[tuple]:
    """Yield (field_number, wire_type, payload_or_value) over a message."""
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:
            length, pos = _read_varint(data, pos)
            yield field, wire, data[pos : pos + length]
            pos += length
        elif wire == 0:
            value, pos = _read_varint(data, pos)
            yield field, wire, value
        elif wire == 5:
            yield field, wire, data[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, data[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def decode_example(payload: bytes) -> Dict[str, object]:
    """Decode an Example payload into {name: list-of-values}."""
    out: Dict[str, object] = {}
    features_msg = b""
    for field, _wire, value in _parse_len_delimited_fields(payload):
        if field == 1:
            features_msg = value
    for field, _wire, entry in _parse_len_delimited_fields(features_msg):
        if field != 1:
            continue
        name = ""
        feature_msg = b""
        for f2, _w2, v2 in _parse_len_delimited_fields(entry):
            if f2 == 1:
                name = v2.decode()
            elif f2 == 2:
                feature_msg = v2
        for f3, _w3, v3 in _parse_len_delimited_fields(feature_msg):
            if f3 == 1:  # BytesList
                values = [
                    v for f4, _w, v in _parse_len_delimited_fields(v3) if f4 == 1
                ]
                out[name] = values
            elif f3 == 2:  # FloatList (packed or repeated)
                floats: List[float] = []
                for f4, w4, v4 in _parse_len_delimited_fields(v3):
                    if f4 != 1:
                        continue
                    if w4 == 2:
                        floats.extend(
                            np.frombuffer(v4, dtype="<f4").tolist()
                        )
                    elif w4 == 5:
                        floats.append(
                            struct.unpack("<f", v4)[0]
                        )
                out[name] = floats
            elif f3 == 3:  # Int64List (packed varints or repeated)
                ints: List[int] = []
                for f4, w4, v4 in _parse_len_delimited_fields(v3):
                    if f4 != 1:
                        continue
                    if w4 == 2:
                        pos = 0
                        while pos < len(v4):
                            raw, pos = _read_varint(v4, pos)
                            if raw >= 1 << 63:
                                raw -= 1 << 64
                            ints.append(raw)
                    elif w4 == 0:
                        raw = v4
                        if raw >= 1 << 63:
                            raw -= 1 << 64
                        ints.append(raw)
                out[name] = ints
    return out


def examples_to_columns(examples: List[Dict[str, object]]) -> Dict[str, np.ndarray]:
    """Column-major numpy batch from decoded examples. The column set is
    the UNION of keys across the batch (optional features may be absent
    from any record, including the first); uniform single-element columns
    squeeze to scalars, anything ragged or partially-missing stays an
    object array of per-row lists."""
    if not examples:
        return {}
    keys: List[str] = []
    for ex in examples:
        for key in ex:
            if key not in keys:
                keys.append(key)
    out: Dict[str, np.ndarray] = {}
    for key in keys:
        rows = [ex.get(key, []) for ex in examples]
        uniform_scalar = all(
            isinstance(r, list) and len(r) == 1 for r in rows
        )
        if uniform_scalar:
            rows = [r[0] for r in rows]
            first = rows[0]
            if isinstance(first, bytes):
                arr = np.empty(len(rows), dtype=object)
                for i, r in enumerate(rows):
                    arr[i] = r
                out[key] = arr
            elif isinstance(first, float):
                out[key] = np.asarray(rows, dtype=np.float32)
            else:
                out[key] = np.asarray(rows, dtype=np.int64)
            continue
        lengths = {len(r) for r in rows if isinstance(r, list)}
        sample = next((r for r in rows if r), [])
        is_bytes = bool(sample) and isinstance(sample[0], bytes)
        if len(lengths) == 1 and not is_bytes:
            # Rectangular numeric lists -> a proper 2-D column.
            dtype = (
                np.float32
                if sample and isinstance(sample[0], float)
                else np.int64
            )
            out[key] = np.asarray(rows, dtype=dtype)
        else:
            # Ragged / partially-missing / bytes: per-row lists, preserved.
            arr = np.empty(len(rows), dtype=object)
            for i, r in enumerate(rows):
                arr[i] = r
            out[key] = arr
    return out
