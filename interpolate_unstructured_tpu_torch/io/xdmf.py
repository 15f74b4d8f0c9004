"""Native XDMF reader (no meshio dependency).

Covers the XDMF flavor written by meshio / FEniCS / ParaView exporters
for unstructured grids: an XML tree (``<Xdmf><Domain><Grid>``) whose
heavy data lives either inline (``Format="XML"``) or in an HDF5
sidecar (``Format="HDF"``, ``file.h5:/path`` references, read via
h5py when available).  Reference parity: the reference converts any
meshio-readable format (convert_to_binary.py:185) and meshio reads
XDMF; this makes the format readable here without meshio.

Scope: the first spatial ``Grid`` (or the first child of a temporal
collection), one ``Topology`` + ``Geometry``, node/cell ``Attribute``
arrays.  Mixed topologies are rejected — the converter rejects
multi-block meshes anyway (io/convert.py: mesh_to_binda_writer).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .vtu import CellBlock, Mesh

# XdmfTopologyType -> (our cell type, points per cell)
_TOPOLOGY_TYPES = {
    "triangle": ("triangle", 3),
    "quadrilateral": ("quad", 4),
    "tetrahedron": ("tetra", 4),
    "hexahedron": ("hexahedron", 8),
}

_DTYPES = {
    ("float", 4): np.float32,
    ("float", 8): np.float64,
    ("int", 4): np.int32,
    ("int", 8): np.int64,
    ("uint", 4): np.uint32,
    ("uint", 8): np.uint64,
    ("char", 1): np.int8,
    ("uchar", 1): np.uint8,
}


def _read_data_item(item, dirname):
    """Materialize one <DataItem> as a numpy array."""
    fmt = item.get("Format", "XML").strip().lower()
    dt_name = item.get("DataType", "Float").strip().lower()
    precision = int(item.get("Precision", "4"))
    dtype = _DTYPES.get((dt_name, precision))
    if dtype is None:
        raise ValueError(
            f"Unsupported XDMF DataType/Precision {dt_name}/{precision}"
        )
    dims = tuple(
        int(d) for d in item.get("Dimensions", "").split()
    ) or None

    if fmt == "xml":
        arr = np.array((item.text or "").split(), dtype=dtype)
    elif fmt == "hdf":
        ref = (item.text or "").strip()
        if ":" not in ref:
            raise ValueError(f"Malformed XDMF HDF reference {ref!r}")
        fname, path = ref.split(":", 1)
        fname = os.path.join(dirname, fname)
        try:
            import h5py  # noqa: PLC0415
        except ImportError as err:  # pragma: no cover - env without h5py
            raise ValueError(
                f"XDMF heavy data in {fname!r} needs h5py"
            ) from err
        with h5py.File(fname, "r") as f:
            arr = np.asarray(f[path])
    elif fmt == "binary":
        fname = os.path.join(dirname, (item.text or "").strip())
        endian = item.get("Endian", "Native").strip().lower()
        dt = np.dtype(dtype)
        if endian == "big":
            dt = dt.newbyteorder(">")
        elif endian == "little":
            dt = dt.newbyteorder("<")
        seek = int(item.get("Seek", "0"))
        with open(fname, "rb") as f:
            f.seek(seek)
            arr = np.fromfile(f, dtype=dt)
    else:
        raise ValueError(f"Unsupported XDMF DataItem format {fmt!r}")
    if dims is not None:
        arr = arr.reshape(dims)
    return arr


def _find_spatial_grid(domain):
    """First Grid carrying a Topology (descending through temporal /
    spatial collections)."""
    for grid in domain.iter("Grid"):
        if grid.find("Topology") is not None:
            return grid
    raise ValueError("XDMF file contains no Grid with a Topology")


def read_xdmf(filename) -> Mesh:
    filename = os.fspath(filename)
    dirname = os.path.dirname(os.path.abspath(filename))
    root = ET.parse(filename).getroot()
    domain = root.find("Domain")
    if domain is None:
        raise ValueError(f"{filename!r}: no <Domain> element")
    grid = _find_spatial_grid(domain)

    topo = grid.find("Topology")
    ttype = (
        topo.get("TopologyType") or topo.get("Type") or ""
    ).strip().lower()
    if ttype not in _TOPOLOGY_TYPES:
        raise ValueError(
            f"Unsupported XDMF TopologyType {ttype!r} "
            f"(supported: {sorted(_TOPOLOGY_TYPES)})"
        )
    cell_type, npc = _TOPOLOGY_TYPES[ttype]
    conn = _read_data_item(topo.find("DataItem"), dirname)
    conn = np.asarray(conn, dtype=np.int64).reshape(-1, npc)

    geom = grid.find("Geometry")
    gtype = (geom.get("GeometryType") or "XYZ").strip().upper()
    pts = np.asarray(
        _read_data_item(geom.find("DataItem"), dirname), dtype=np.float64
    )
    if gtype == "XY":
        pts = pts.reshape(-1, 2)
        pts = np.pad(pts, ((0, 0), (0, 1)))
    elif gtype == "XYZ":
        pts = pts.reshape(-1, 3)
    elif gtype in ("X_Y_Z", "X_Y"):
        raise ValueError(
            f"Split-coordinate GeometryType {gtype} not supported"
        )
    else:
        raise ValueError(f"Unsupported XDMF GeometryType {gtype!r}")

    point_data, cell_data = {}, {}
    for att in grid.findall("Attribute"):
        name = att.get("Name", "unnamed")
        center = (att.get("Center") or "Node").strip().lower()
        data = np.asarray(
            _read_data_item(att.find("DataItem"), dirname)
        ).squeeze()
        if center == "node":
            point_data[name] = data
        elif center == "cell":
            cell_data[name] = data
        # Grid/other centers: not representable, skipped

    return Mesh(
        points=pts,
        cells=[CellBlock(type=cell_type, data=conn)],
        point_data=point_data,
        cell_data=cell_data,
    )
