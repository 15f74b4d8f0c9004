"""VTK XML UnstructuredGrid (.vtu) writer with raw appended encoding.

Produces the same file structure as the reference writer (m_vtk.f90 +
iu_write_vtk, m_interp_unstructured.f90:929-985):

* ``format="appended"``, ``encoding="raw"`` binary payload after ``_``
* points downcast to Float32 (m_vtk.f90:79), interleaved xyz
* connectivity/offsets/types as Int32, real variables Float64,
  integer variables Int32
* each appended array prefixed by an int32 byte count (default UInt32
  header type, m_vtk.f90:97)
* cell type ids: triangle=5, quad=9, tetra=10
  (m_interp_unstructured.f90:941-950)
"""

from __future__ import annotations

import numpy as np

from .vtu import CELL_TYPE_TO_VTK


class VtuWriter:
    """Streaming-ish writer: XML header text plus an appended binary blob."""

    def __init__(self):
        self._xml = []
        self._blob = bytearray()
        self._indent = 0

    # -- low level ---------------------------------------------------------
    def _line(self, text):
        self._xml.append(" " * self._indent + text)

    def open_tag(self, tag, attrs=""):
        self._line(f"<{tag}{attrs}>")
        self._indent += 2

    def close_tag(self, tag):
        self._indent -= 2
        self._line(f"</{tag}>")

    def _append_payload(self, arr: np.ndarray) -> int:
        """Add one length-prefixed array to the appended blob; returns the
        byte offset to reference in the DataArray element."""
        offset = len(self._blob)
        payload = np.ascontiguousarray(arr).tobytes()
        self._blob.extend(np.int32(len(payload)).tobytes())
        self._blob.extend(payload)
        return offset

    def data_array(self, vtk_type, name, arr, n_components=1):
        offset = self._append_payload(arr)
        ncomp = f' NumberOfComponents="{n_components}"' if n_components else ""
        nm = f' Name="{name}"' if name else ""
        self._line(
            f'<DataArray type="{vtk_type}"{nm}{ncomp} '
            f'format="appended" offset="{offset}"/>'
        )

    # -- high level ---------------------------------------------------------
    def write(self, filename):
        header = (
            '<?xml version="1.0"?>\n'
            '<VTKFile type="UnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n'
        )
        with open(filename, "wb") as f:
            f.write(header.encode())
            f.write(("\n".join("  " + l for l in self._xml) + "\n").encode())
            f.write(b'  <AppendedData encoding="raw">\n   _')
            f.write(bytes(self._blob))
            f.write(b"\n  </AppendedData>\n</VTKFile>\n")


def write_vtu(
    filename,
    points: np.ndarray,
    cells: np.ndarray,
    cell_type: str,
    point_data: dict | None = None,
    cell_data: dict | None = None,
    icell_data: dict | None = None,
):
    """Write an unstructured grid to a .vtu file.

    Args:
      points: (n_points, 3) float coordinates.
      cells: (n_cells, n_points_per_cell) 0-based connectivity.
      cell_type: "triangle" | "quad" | "tetra".
      point_data / cell_data: name -> float array.
      icell_data: name -> integer array.
    """
    points = np.asarray(points, dtype=np.float64)
    cells = np.asarray(cells)
    n_points, n_cells = len(points), len(cells)
    npc = cells.shape[1]
    if cell_type not in CELL_TYPE_TO_VTK:
        raise ValueError(f"Unsupported cell type {cell_type!r}")

    w = VtuWriter()
    w.open_tag("UnstructuredGrid")
    w.open_tag(
        "Piece", f' NumberOfPoints="{n_points}" NumberOfCells="{n_cells}"'
    )

    w.open_tag("Points")
    w.data_array("Float32", "Points", points.astype(np.float32), 3)
    w.close_tag("Points")

    w.open_tag("Cells")
    w.data_array("Int32", "connectivity", cells.astype(np.int32).reshape(-1), None)
    offsets = (np.arange(1, n_cells + 1, dtype=np.int32) * npc)
    w.data_array("Int32", "offsets", offsets, None)
    types = np.full(n_cells, CELL_TYPE_TO_VTK[cell_type], dtype=np.int32)
    w.data_array("Int32", "types", types, None)
    w.close_tag("Cells")

    w.open_tag("CellData")
    for name, arr in (cell_data or {}).items():
        w.data_array("Float64", name, np.asarray(arr, dtype=np.float64))
    for name, arr in (icell_data or {}).items():
        w.data_array("Int32", name, np.asarray(arr, dtype=np.int32))
    w.close_tag("CellData")

    w.open_tag("PointData")
    for name, arr in (point_data or {}).items():
        w.data_array("Float64", name, np.asarray(arr, dtype=np.float64))
    w.close_tag("PointData")

    w.close_tag("Piece")
    w.close_tag("UnstructuredGrid")
    w.write(filename)


def write_vtu_polylines(
    filename,
    points: np.ndarray,
    offsets: np.ndarray,
    point_data: dict | None = None,
    ipoint_data: dict | None = None,
):
    """Write polylines (VTK cell type 4) to a .vtu file.

    No reference counterpart (iu_write_vtk exports only the grid,
    :929-985) — this serves trace-result visualization.

    Args:
      points: (n_total, 3) concatenated polyline vertices.
      offsets: (n_lines,) int, cumulative END index of each line.
      point_data / ipoint_data: name -> (n_total,) per-vertex arrays.
    """
    points = np.asarray(points, dtype=np.float64)
    offsets = np.asarray(offsets, dtype=np.int32)
    n_points, n_lines = len(points), len(offsets)

    w = VtuWriter()
    w.open_tag("UnstructuredGrid")
    w.open_tag(
        "Piece", f' NumberOfPoints="{n_points}" NumberOfCells="{n_lines}"'
    )
    w.open_tag("Points")
    w.data_array("Float32", "Points", points.astype(np.float32), 3)
    w.close_tag("Points")

    w.open_tag("Cells")
    w.data_array(
        "Int32", "connectivity", np.arange(n_points, dtype=np.int32), None
    )
    w.data_array("Int32", "offsets", offsets, None)
    w.data_array("Int32", "types", np.full(n_lines, 4, dtype=np.int32), None)
    w.close_tag("Cells")

    w.open_tag("PointData")
    for name, arr in (point_data or {}).items():
        w.data_array("Float64", name, np.asarray(arr, dtype=np.float64))
    for name, arr in (ipoint_data or {}).items():
        w.data_array("Int32", name, np.asarray(arr, dtype=np.int32))
    w.close_tag("PointData")

    w.close_tag("Piece")
    w.close_tag("UnstructuredGrid")
    w.write(filename)
