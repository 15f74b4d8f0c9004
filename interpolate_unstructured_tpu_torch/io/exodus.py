"""Native Exodus II reader (no meshio/netCDF4 dependency).

Exodus II files are NetCDF-3 containers (classic or 64-bit-offset),
which ``scipy.io.netcdf_file`` reads directly.  Reference parity: the
reference converts any meshio-readable format
(convert_to_binary.py:185) and meshio reads Exodus; this makes the
format readable here without meshio.

Scope: coordinates (``coord`` or ``coordx/y/z``), all element blocks
(``connect<i>``, 1-based, with ``elem_type`` attributes), nodal
variables (last time step), and element variables when a single block
is present.  HDF5-based "netCDF-4 Exodus" files are rejected with a
clear error (scipy's reader is NetCDF-3-only).
"""

from __future__ import annotations

import os

import numpy as np

from .vtu import CellBlock, Mesh

_ELEM_TYPES = {
    "tri": "triangle",
    "tri3": "triangle",
    "triangle": "triangle",
    "quad": "quad",
    "quad4": "quad",
    "shell4": "quad",
    "tet": "tetra",
    "tet4": "tetra",
    "tetra": "tetra",
    "tetra4": "tetra",
    "hex": "hexahedron",
    "hex8": "hexahedron",
}


def _names(var) -> list[str]:
    """Decode an Exodus (n, len) char-array of names."""
    out = []
    for row in np.asarray(var[:]):
        out.append(
            b"".join(row.reshape(-1)).decode("ascii", "replace").strip("\x00 ")
        )
    return out


def read_exodus(filename) -> Mesh:
    filename = os.fspath(filename)
    from scipy.io import netcdf_file

    try:
        nc = netcdf_file(filename, "r", mmap=False)
    except (ValueError, OSError) as err:
        raise ValueError(
            f"{filename!r} is not a NetCDF-3 Exodus file (HDF5-based "
            "Exodus needs netCDF4, which is not installed)"
        ) from err
    try:
        ndim = nc.dimensions.get("num_dim", 3)
        nn = nc.dimensions["num_nodes"]
        if "coord" in nc.variables:
            coord = np.asarray(
                nc.variables["coord"][:], dtype=np.float64
            )  # (ndim, nn)
        else:
            axes = [
                np.asarray(nc.variables[f"coord{ax}"][:], dtype=np.float64)
                for ax in "xyz"[:ndim]
            ]
            coord = np.stack(axes, axis=0)
        points = np.zeros((nn, 3), dtype=np.float64)
        points[:, : coord.shape[0]] = coord.T

        cells = []
        i = 1
        while f"connect{i}" in nc.variables:
            v = nc.variables[f"connect{i}"]
            et = getattr(v, "elem_type", b"")
            et = (
                et.decode("ascii", "replace") if isinstance(et, bytes) else et
            ).strip().lower()
            if et not in _ELEM_TYPES:
                raise ValueError(
                    f"Unsupported Exodus elem_type {et!r} in block {i} "
                    f"(supported: {sorted(set(_ELEM_TYPES))})"
                )
            conn = np.asarray(v[:], dtype=np.int64) - 1  # 1-based
            cells.append(CellBlock(type=_ELEM_TYPES[et], data=conn))
            i += 1
        if not cells:
            raise ValueError(f"{filename!r} has no element blocks")

        point_data = {}
        if "name_nod_var" in nc.variables:
            names = _names(nc.variables["name_nod_var"])
            for j, name in enumerate(names, start=1):
                # two layouts: one var per field, or a single stacked var
                if f"vals_nod_var{j}" in nc.variables:
                    vals = np.asarray(
                        nc.variables[f"vals_nod_var{j}"][:], dtype=np.float64
                    )
                    point_data[name] = vals[-1]  # last time step
                elif "vals_nod_var" in nc.variables:
                    vals = np.asarray(
                        nc.variables["vals_nod_var"][:], dtype=np.float64
                    )
                    point_data[name] = vals[-1, j - 1]

        cell_data = {}
        if len(cells) == 1 and "name_elem_var" in nc.variables:
            names = _names(nc.variables["name_elem_var"])
            for j, name in enumerate(names, start=1):
                key = f"vals_elem_var{j}eb1"
                if key in nc.variables:
                    vals = np.asarray(
                        nc.variables[key][:], dtype=np.float64
                    )
                    cell_data[name] = vals[-1]

        return Mesh(
            points=points,
            cells=cells,
            point_data=point_data,
            cell_data=cell_data,
        )
    finally:
        nc.close()
