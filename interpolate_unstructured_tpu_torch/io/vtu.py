"""Minimal VTK XML UnstructuredGrid (.vtu) reader.

The reference delegates mesh ingestion to ``meshio``
(convert_to_binary.py:185); meshio is not available in this environment, so
this is a self-contained reader covering the formats the VTK XML spec allows
and that the bundled fixtures use:

* ``format="ascii"`` (also when the attribute is omitted — VTK's default)
* ``format="appended"`` with ``encoding="raw"`` or ``encoding="base64"``
* ``format="binary"`` (inline base64)
* ``header_type`` UInt32 (default) or UInt64
* optional ``compressor="vtkZLibDataCompressor"``

Only what the pipeline needs is extracted: points, cell connectivity
(homogeneous blocks by VTK type), point data, and cell data.
"""

from __future__ import annotations

import base64
import re
import zlib
from dataclasses import dataclass, field
from xml.etree import ElementTree

import numpy as np

_VTK_TO_NP = {
    "Int8": np.int8,
    "UInt8": np.uint8,
    "Int16": np.int16,
    "UInt16": np.uint16,
    "Int32": np.int32,
    "UInt32": np.uint32,
    "Int64": np.int64,
    "UInt64": np.uint64,
    "Float32": np.float32,
    "Float64": np.float64,
}

# VTK cell type id -> (name, n_points). Only linear 2D/3D simplex-ish types
# the framework supports, plus a few recognized-but-unsupported ones so we
# can give good error messages.
VTK_CELL_TYPES = {
    3: ("line", 2),
    5: ("triangle", 3),
    9: ("quad", 4),
    10: ("tetra", 4),
    12: ("hexahedron", 8),
    13: ("wedge", 6),
    14: ("pyramid", 5),
}

CELL_TYPE_TO_VTK = {name: tid for tid, (name, _) in VTK_CELL_TYPES.items()}


@dataclass
class CellBlock:
    type: str  # "triangle" | "quad" | "tetra" | ...
    data: np.ndarray  # (n_cells, n_points_per_cell) int64, 0-based


@dataclass
class Mesh:
    """In-memory unstructured mesh, mirroring the slice of meshio's Mesh
    that the converter uses (convert_to_binary.py:185-224)."""

    points: np.ndarray  # (n_points, 3) float64
    cells: list  # list[CellBlock]
    point_data: dict = field(default_factory=dict)  # name -> (n_points,) array
    cell_data: dict = field(default_factory=dict)  # name -> (n_cells,) array


def _split_appended_blob(raw: bytes):
    """Split the file into XML text, the appended blob, and its encoding.

    A raw-encoded <AppendedData> section is not valid XML, so locate it
    byte-wise, cut the blob out, and hand ElementTree a sanitized
    document.  base64 blobs stay ENCODED: DataArray ``offset``
    attributes count encoded characters, and each array's header/data
    are independent base64 blocks — a whole-stream decode would stop at
    the first block's ``=`` padding and corrupt every later array.
    """
    m = re.search(rb"<AppendedData[^>]*>", raw)
    if m is None:
        return raw, None, None
    enc_m = re.search(rb'encoding="([^"]+)"', m.group(0))
    encoding = enc_m.group(1).decode() if enc_m else "base64"
    start = m.end()
    end = raw.rfind(b"</AppendedData>")
    if end < 0:
        raise ValueError("Unterminated <AppendedData> section")
    blob = raw[start:end]
    # Data begins after the first '_' marker
    underscore = blob.find(b"_")
    if underscore < 0:
        raise ValueError("<AppendedData> has no '_' marker")
    blob = blob[underscore + 1 :]
    xml_text = raw[: m.end()] + raw[end:]
    return xml_text, blob, encoding


def _decode_block(buf, header_dtype, compressed: bool) -> bytes:
    """Decode one header-prefixed RAW data block (possibly zlib
    compressed)."""
    hsize = np.dtype(header_dtype).itemsize
    if not compressed:
        (nbytes,) = np.frombuffer(buf[:hsize], dtype=header_dtype)
        return buf[hsize : hsize + int(nbytes)]
    # Compressed layout: [n_blocks, uncompressed_block_size, last_block_size,
    #                     compressed_size_0..n-1] then the compressed blocks.
    (n_blocks,) = np.frombuffer(buf[:hsize], dtype=header_dtype)
    n_blocks = int(n_blocks)
    header = np.frombuffer(buf[: hsize * (3 + n_blocks)], dtype=header_dtype)
    comp_sizes = header[3 : 3 + n_blocks].astype(np.int64)
    pos = hsize * (3 + n_blocks)
    out = bytearray()
    for cs in comp_sizes:
        out.extend(zlib.decompress(buf[pos : pos + int(cs)]))
        pos += int(cs)
    return bytes(out)


def _b64_chars(n_bytes: int) -> int:
    return -(-n_bytes // 3) * 4


def _b64_body(buf, header_nbytes: int, body_nbytes: int) -> bytes:
    """Extract ``body_nbytes`` following a ``header_nbytes`` header from
    a base64 region, handling BOTH encoding conventions:

    * VTK/meshio: header and data are SEPARATE base64 blocks, each
      padded to a 4-char boundary — detectable because the header block
      then ends in '=' padding whenever header_nbytes % 3 != 0;
    * single stream: header+data encoded together (when
      header_nbytes % 3 == 0 the two conventions coincide exactly, so
      the padding probe is only consulted when it is meaningful).
    """
    hchars = _b64_chars(header_nbytes)
    if header_nbytes % 3 == 0 or buf[hchars - 1 : hchars] == b"=":
        data = base64.b64decode(
            buf[hchars : hchars + _b64_chars(body_nbytes)]
        )
        return data[:body_nbytes]
    s = bytes(buf[: _b64_chars(header_nbytes + body_nbytes)])
    whole = base64.b64decode(s + b"=" * ((-len(s)) % 4))
    return whole[header_nbytes : header_nbytes + body_nbytes]


def _decode_block_b64(buf, header_dtype, compressed: bool) -> bytes:
    """Decode one base64-encoded block starting at ``buf[0]``
    (see :func:`_b64_body` for the two encoding conventions)."""
    hsize = np.dtype(header_dtype).itemsize
    head = base64.b64decode(buf[: _b64_chars(hsize)])
    if not compressed:
        (nbytes,) = np.frombuffer(head[:hsize], dtype=header_dtype)
        return _b64_body(buf, hsize, int(nbytes))
    (n_blocks,) = np.frombuffer(head[:hsize], dtype=header_dtype)
    n_blocks = int(n_blocks)
    nhb = hsize * (3 + n_blocks)
    # The 4-char-aligned prefix of either convention decodes cleanly to
    # at least the full compression header (a separate header block is
    # exactly _b64_chars(nhb) long incl. padding; a single stream's
    # prefix decodes to >= nhb bytes)
    header = np.frombuffer(
        base64.b64decode(buf[: _b64_chars(nhb)])[:nhb],
        dtype=header_dtype,
    )
    comp_sizes = header[3 : 3 + n_blocks].astype(np.int64)
    data = _b64_body(buf, nhb, int(comp_sizes.sum()))
    out = bytearray()
    pos = 0
    for cs in comp_sizes:
        out.extend(zlib.decompress(data[pos : pos + int(cs)]))
        pos += int(cs)
    return bytes(out)


def _read_data_array(elem, blob, encoding, header_dtype, compressed):
    dtype = _VTK_TO_NP[elem.attrib["type"]]
    fmt = elem.attrib.get("format", "ascii")
    if fmt == "ascii":
        text = elem.text or ""
        if np.issubdtype(dtype, np.floating):
            arr = np.array(text.split(), dtype=np.float64).astype(dtype)
        else:
            arr = np.array(text.split(), dtype=np.int64).astype(dtype)
        return arr
    if fmt == "appended":
        if blob is None:
            raise ValueError("appended DataArray but no <AppendedData> blob")
        offset = int(elem.attrib.get("offset", "0"))
        if encoding == "base64":
            payload = _decode_block_b64(
                blob[offset:], header_dtype, compressed
            )
        else:
            payload = _decode_block(blob[offset:], header_dtype, compressed)
        return np.frombuffer(payload, dtype=np.dtype(dtype).newbyteorder("<"))
    if fmt == "binary":
        text = "".join((elem.text or "").split()).encode()
        payload = _decode_block_b64(text, header_dtype, compressed)
        return np.frombuffer(payload, dtype=np.dtype(dtype).newbyteorder("<"))
    raise ValueError(f"Unsupported DataArray format {fmt!r}")


def read_vtu(filename) -> Mesh:
    with open(filename, "rb") as f:
        raw = f.read()

    xml_text, blob, encoding = _split_appended_blob(raw)
    root = ElementTree.fromstring(xml_text)
    if root.tag != "VTKFile" or root.attrib.get("type") != "UnstructuredGrid":
        raise ValueError(f"{filename} is not a VTK XML UnstructuredGrid file")
    byte_order = root.attrib.get("byte_order", "LittleEndian")
    if byte_order != "LittleEndian":
        raise ValueError("Only LittleEndian .vtu files are supported")
    header_dtype = _VTK_TO_NP[root.attrib.get("header_type", "UInt32")]
    compressor = root.attrib.get("compressor")
    compressed = compressor == "vtkZLibDataCompressor"
    if compressor not in (None, "", "vtkZLibDataCompressor"):
        raise ValueError(f"Unsupported compressor {compressor!r}")

    grid = root.find("UnstructuredGrid")
    pieces = grid.findall("Piece")
    if len(pieces) > 1:
        # legal per the VTK XML spec: merge (point indices offset per
        # piece); silently reading only piece 0 would drop mesh parts
        parts = [
            _read_piece(p, blob, encoding, header_dtype, compressed)
            for p in pieces
        ]
        return _merge_meshes(parts)
    return _read_piece(pieces[0], blob, encoding, header_dtype, compressed)


def _merge_meshes(parts) -> Mesh:
    offset = 0
    points = []
    blocks: dict = {}
    point_data: dict = {}
    cell_data: dict = {}
    for m in parts:
        points.append(m.points)
        for cb in m.cells:
            blocks.setdefault(cb.type, []).append(cb.data + offset)
        for name, arr in m.point_data.items():
            point_data.setdefault(name, []).append(arr)
        for name, arr in m.cell_data.items():
            cell_data.setdefault(name, []).append(arr)
        offset += len(m.points)
    return Mesh(
        points=np.concatenate(points),
        cells=[
            CellBlock(t, np.concatenate(bs)) for t, bs in blocks.items()
        ],
        point_data={n: np.concatenate(a) for n, a in point_data.items()},
        cell_data={n: np.concatenate(a) for n, a in cell_data.items()},
    )


def _read_piece(piece, blob, encoding, header_dtype, compressed) -> Mesh:
    n_points = int(piece.attrib["NumberOfPoints"])
    n_cells = int(piece.attrib["NumberOfCells"])

    def rd(elem):
        return _read_data_array(elem, blob, encoding, header_dtype, compressed)

    # Points
    pts_elem = piece.find("Points").find("DataArray")
    n_comp = int(pts_elem.attrib.get("NumberOfComponents", "3"))
    points = rd(pts_elem).astype(np.float64).reshape(n_points, n_comp)
    if n_comp < 3:  # always store 3D coordinates (m_interp_unstructured.f90:37)
        points = np.pad(points, ((0, 0), (0, 3 - n_comp)))

    # Cells
    cells_elem = piece.find("Cells")
    arrays = {}
    for da in cells_elem.findall("DataArray"):
        arrays[da.attrib["Name"]] = rd(da)
    connectivity = arrays["connectivity"].astype(np.int64)
    offsets = arrays["offsets"].astype(np.int64)
    types = arrays["types"].astype(np.int64)
    if len(offsets) != n_cells or len(types) != n_cells:
        raise ValueError("Inconsistent cell arrays")

    # Group consecutive runs of the same cell type into homogeneous blocks
    cells = []
    begin = 0
    i = 0
    while i < n_cells:
        t = types[i]
        j = i
        while j < n_cells and types[j] == t:
            j += 1
        if int(t) not in VTK_CELL_TYPES:
            raise ValueError(f"Unsupported VTK cell type id {int(t)}")
        name, npc = VTK_CELL_TYPES[int(t)]
        conn_end = offsets[j - 1]
        block = connectivity[begin:conn_end].reshape(j - i, npc)
        cells.append(CellBlock(name, block))
        begin = conn_end
        i = j

    mesh = Mesh(points=points, cells=cells)

    pd = piece.find("PointData")
    if pd is not None:
        for da in pd.findall("DataArray"):
            name = da.attrib.get("Name", f"point_array_{len(mesh.point_data)}")
            arr = rd(da)
            ncomp = int(da.attrib.get("NumberOfComponents", "1"))
            if ncomp > 1:
                arr = arr.reshape(n_points, ncomp)
            mesh.point_data[name] = arr

    cd = piece.find("CellData")
    if cd is not None:
        for da in cd.findall("DataArray"):
            name = da.attrib.get("Name", f"cell_array_{len(mesh.cell_data)}")
            arr = rd(da)
            ncomp = int(da.attrib.get("NumberOfComponents", "1"))
            if ncomp > 1:
                arr = arr.reshape(n_cells, ncomp)
            mesh.cell_data[name] = arr

    return mesh
