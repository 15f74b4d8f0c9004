"""Reader/writer for the "BInary N-dimensional DAta" (binda) container.

The port's copy of the JAX package's ``io/binda.py``, unchanged in
behaviour, so that both packages write the same bytes.

Format parity with the reference implementation (``m_binda.f90``
reader, ``convert_to_binary.py:11-115`` writer):

    bytes 0..7    : magic ``b"BINDA   "`` (8 bytes, space padded ASCII)
    bytes 8..15   : int64 little-endian ``n_entries``
    bytes 16..23  : int64 ``total_header_size``
    then per entry (n_entries times):
        128s name | 128s dtype | 128s metadata | int64 ndim |
        8 * int64 shape (zero padded) | int64 offset
    payload blob follows; entry offsets are absolute file offsets
    (the Fortran reader seeks to ``pos=offset+1``, m_binda.f90:104).

Data payloads are stored C-contiguous in the declared shape; integer data
is written as int32 (convert_to_binary.py:48-49).  Readers widen
int64 -> int32 and float32 -> float64 like m_binda.f90:101-134.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

_MAGIC = b"BINDA   "
_ENTRY_STRUCT = struct.Struct("<128s128s128sq8qq")
_HEAD_STRUCT = struct.Struct("<8sqq")
_MAX_NDIM = 8

# dtype strings as produced by ``str(np.dtype)`` on the writer side
_DTYPES = {
    "float64": np.float64,
    "float32": np.float32,
    "int64": np.int64,
    "int32": np.int32,
}


@dataclass
class BindaEntry:
    name: str
    dtype: str
    metadata: str
    shape: tuple
    offset: int  # absolute file offset of the payload


@dataclass
class BindaFile:
    """Parsed binda container: header entries plus raw payload access."""

    entries: list = field(default_factory=list)
    _buf: bytes = b""

    # -- queries ---------------------------------------------------------
    @property
    def names(self):
        return [e.name for e in self.entries]

    def index(self, name: str) -> int:
        """First index whose name matches, -1 if absent (m_binda.f90:184)."""
        for i, e in enumerate(self.entries):
            if e.name == name:
                return i
        return -1

    def indices(self, name: str):
        return [i for i, e in enumerate(self.entries) if e.name == name]

    # -- payload decoding --------------------------------------------------
    def read(self, ix: int) -> np.ndarray:
        e = self.entries[ix]
        if e.dtype not in _DTYPES:
            raise ValueError(f"Unsupported binda dtype {e.dtype!r}")
        dt = np.dtype(_DTYPES[e.dtype]).newbyteorder("<")
        count = int(np.prod(e.shape)) if e.shape else 1
        arr = np.frombuffer(self._buf, dtype=dt, count=count, offset=e.offset)
        return arr.reshape(e.shape)

    def read_float64(self, ix: int) -> np.ndarray:
        """Read entry, widening float32 -> float64 (m_binda.f90:115-135)."""
        arr = self.read(ix)
        if not np.issubdtype(arr.dtype, np.floating):
            raise TypeError(f"Entry {ix} has dtype {arr.dtype}, not float")
        return np.ascontiguousarray(arr, dtype=np.float64)

    def read_int32(self, ix: int) -> np.ndarray:
        """Read entry, narrowing int64 -> int32 (m_binda.f90:90-113)."""
        arr = self.read(ix)
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"Entry {ix} has dtype {arr.dtype}, not integer")
        return np.ascontiguousarray(arr, dtype=np.int32)


def read_binda(filename) -> BindaFile:
    with open(filename, "rb") as f:
        buf = f.read()

    magic, n_entries, total_header_size = _HEAD_STRUCT.unpack_from(buf, 0)
    if magic[:5] != b"BINDA":
        raise ValueError(f"{filename}: wrong file format (magic={magic!r})")

    entries = []
    pos = _HEAD_STRUCT.size
    for _ in range(n_entries):
        fields = _ENTRY_STRUCT.unpack_from(buf, pos)
        pos += _ENTRY_STRUCT.size
        name, dtype_s, metadata = (
            fields[0].decode("ascii").strip(),
            fields[1].decode("ascii").strip(),
            fields[2].decode("ascii").strip(),
        )
        ndim = fields[3]
        shape = tuple(int(s) for s in fields[4 : 4 + ndim])
        offset = fields[12]
        entries.append(BindaEntry(name, dtype_s, metadata, shape, offset))

    if pos != total_header_size:
        raise ValueError(
            f"{filename}: header size mismatch ({pos} != {total_header_size})"
        )
    return BindaFile(entries=entries, _buf=buf)


class BindaWriter:
    """Accumulates named arrays, then writes a binda container.

    Byte-compatible with the reference writer
    (convert_to_binary.py:11-115): names/dtypes/metadata are space padded
    to 128 ASCII chars, integer data is forced to int32, offsets are
    absolute (header size added at write time).
    """

    def __init__(self):
        self._entries = []
        self._blob = bytearray()

    def add_entry(self, name: str, data: np.ndarray, metadata: str = ""):
        if len(name) > 128:
            raise ValueError(
                f"Entry name longer than the 128-byte header field: {name!r}"
            )
        if len(metadata) > 128:
            raise ValueError("Entry metadata longer than the 128-byte header field")
        data = np.asarray(data)
        if data.ndim > _MAX_NDIM:
            raise ValueError(
                f"binda headers hold at most 8 dims, array has {data.ndim}"
            )
        if np.issubdtype(data.dtype, np.integer):
            info = np.iinfo(np.int32)
            if data.size and (
                int(data.min()) < info.min or int(data.max()) > info.max
            ):
                raise ValueError(
                    f"Entry {name!r} has values outside int32 range "
                    "(the binda format stores integers as int32, "
                    "convert_to_binary.py:48-49)"
                )
            data = data.astype(np.int32)
        payload = np.ascontiguousarray(data).tobytes()
        offset = len(self._blob)
        self._blob.extend(payload)
        self._entries.append((name, str(data.dtype), metadata, data.shape, offset))

    def write_to_file(self, filename):
        n_entries = len(self._entries)
        total_header_size = _HEAD_STRUCT.size + n_entries * _ENTRY_STRUCT.size
        with open(filename, "wb") as f:
            f.write(_HEAD_STRUCT.pack(_MAGIC, n_entries, total_header_size))
            for name, dtype_s, metadata, shape, offset in self._entries:
                shape_padded = tuple(shape) + (0,) * (_MAX_NDIM - len(shape))
                f.write(
                    _ENTRY_STRUCT.pack(
                        name.ljust(128).encode("ascii"),
                        dtype_s.ljust(128).encode("ascii"),
                        metadata.ljust(128).encode("ascii"),
                        len(shape),
                        *shape_padded,
                        offset + total_header_size,
                    )
                )
            f.write(bytes(self._blob))


def main(argv=None):
    """CLI: list the entries of a binda container."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Inspect a BINDA container (entries, dtypes, shapes)"
    )
    parser.add_argument("file", help="path to a .binda file")
    args = parser.parse_args(argv)
    bf = read_binda(args.file)
    print(f"{args.file}: {len(bf.entries)} entries")
    for i, e in enumerate(bf.entries):
        meta = f"  [{e.metadata}]" if e.metadata else ""
        print(
            f"  {i:3d}  {e.name:<16s} {e.dtype:<8s} "
            f"shape={e.shape} offset={e.offset}{meta}"
        )


if __name__ == "__main__":
    main()
