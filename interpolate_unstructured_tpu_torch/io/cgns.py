"""Native CGNS (HDF5 flavor) reader for unstructured zones.

CGNS/HDF5 maps the ADF tree onto HDF5: every node is a group with
``name``/``label``/``type`` attributes and its payload in a child
dataset literally named ``" data"`` (note the leading space).  This
reads the first ``Zone_t`` of the first ``CGNSBase_t``: coordinates
(``GridCoordinates_t`` → ``CoordinateX/Y/Z``), uniform-type
``Elements_t`` sections (TRI_3 / QUAD_4 / TETRA_4 / HEXA_8, 1-based
flat connectivity), and vertex/cell-centered ``FlowSolution_t``
arrays.  Reference parity: the reference converts any meshio-readable
format (convert_to_binary.py:185); CGNS was the last named family not
readable here.  ADF-flavor (non-HDF5) CGNS files are rejected with a
clear error.
"""

from __future__ import annotations

import os

import numpy as np

from .vtu import CellBlock, Mesh

# CGNS ElementType_t codes -> (our cell type, points per cell)
_ELEMENT_TYPES = {
    5: ("triangle", 3),   # TRI_3
    7: ("quad", 4),       # QUAD_4
    10: ("tetra", 4),     # TETRA_4
    17: ("hexahedron", 8),  # HEXA_8
}
# Codes we recognize but cannot build a grid from (boundary patches
# etc.) — skipped rather than rejected, like meshio does.
_SKIPPED_TYPES = {2, 3, 4}  # Node, BAR_2, BAR_3


def _label(node) -> str:
    lab = node.attrs.get("label", b"")
    return lab.decode("ascii", "replace").strip("\x00 ") if isinstance(
        lab, bytes
    ) else str(lab)


def _data(node):
    if " data" in node:
        return np.asarray(node[" data"])
    return None


def _children_by_label(node, label):
    import h5py

    out = []
    for key in node:
        child = node[key]
        if isinstance(child, h5py.Group) and _label(child) == label:
            out.append(child)
    return out


def _string_data(node) -> str:
    d = _data(node)
    if d is None:
        return ""
    return d.astype(np.uint8).tobytes().decode(
        "ascii", "replace"
    ).strip("\x00 ")


def read_cgns(filename) -> Mesh:
    filename = os.fspath(filename)
    try:
        import h5py  # noqa: PLC0415
    except ImportError as err:  # pragma: no cover - env without h5py
        raise ValueError("Reading CGNS needs h5py") from err
    if not h5py.is_hdf5(filename):
        raise ValueError(
            f"{filename!r} is not an HDF5 file — ADF-flavor CGNS is not "
            "supported (convert it with `cgnsconvert -h`)"
        )
    with h5py.File(filename, "r") as f:
        bases = _children_by_label(f, "CGNSBase_t")
        if not bases:
            raise ValueError(f"{filename!r}: no CGNSBase_t node")
        zones = _children_by_label(bases[0], "Zone_t")
        if not zones:
            raise ValueError(f"{filename!r}: no Zone_t node")
        zone = zones[0]

        ztypes = _children_by_label(zone, "ZoneType_t")
        ztype = _string_data(ztypes[0]) if ztypes else "Unstructured"
        if ztype != "Unstructured":
            raise ValueError(
                f"Unsupported CGNS ZoneType {ztype!r} (only Unstructured)"
            )

        gcs = _children_by_label(zone, "GridCoordinates_t")
        if not gcs:
            raise ValueError(f"{filename!r}: no GridCoordinates_t node")
        axes = []
        for name in ("CoordinateX", "CoordinateY", "CoordinateZ"):
            if name in gcs[0]:
                axes.append(
                    np.asarray(_data(gcs[0][name]), dtype=np.float64)
                )
        if not axes:
            raise ValueError(f"{filename!r}: no coordinate arrays")
        points = np.zeros((len(axes[0]), 3), dtype=np.float64)
        for c, ax in enumerate(axes):
            points[:, c] = ax

        cells = []
        cell_ranges = []  # (start, end) 1-based element-id ranges
        for sec in _children_by_label(zone, "Elements_t"):
            et = int(np.asarray(_data(sec)).reshape(-1)[0])
            if et in _SKIPPED_TYPES:
                continue
            if et not in _ELEMENT_TYPES:
                raise ValueError(
                    f"Unsupported CGNS ElementType {et} in section "
                    f"{_label(sec)!r} (supported codes: "
                    f"{sorted(_ELEMENT_TYPES)})"
                )
            cell_type, npc = _ELEMENT_TYPES[et]
            conn = np.asarray(
                _data(sec["ElementConnectivity"]), dtype=np.int64
            ).reshape(-1, npc) - 1  # 1-based
            cells.append(CellBlock(type=cell_type, data=conn))
            rng = _data(sec["ElementRange"]) if "ElementRange" in sec \
                else None
            cell_ranges.append(
                tuple(int(x) for x in np.asarray(rng).reshape(-1)[:2])
                if rng is not None
                else (1, len(conn))
            )
        if not cells:
            raise ValueError(f"{filename!r} has no volume element section")

        point_data, cell_data = {}, {}
        for sol in _children_by_label(zone, "FlowSolution_t"):
            locs = _children_by_label(sol, "GridLocation_t")
            loc = _string_data(locs[0]) if locs else "Vertex"
            for arr in _children_by_label(sol, "DataArray_t"):
                name = arr.attrs.get("name", b"")
                name = name.decode("ascii", "replace").strip("\x00 ") \
                    if isinstance(name, bytes) else str(name)
                vals = np.asarray(_data(arr), dtype=np.float64).reshape(-1)
                if loc == "Vertex":
                    point_data[name] = vals
                elif loc == "CellCenter":
                    cell_data[name] = vals

        return Mesh(
            points=points,
            cells=cells,
            point_data=point_data,
            cell_data=cell_data,
        )
