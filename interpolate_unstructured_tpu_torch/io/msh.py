"""Native Gmsh ``.msh`` reader (format versions 2.2 and 4.1, ASCII and
binary, both endiannesses).

Closes the mesh-ingestion gap left by the absent meshio dependency: the
reference converts *any* meshio-supported format
(convert_to_binary.py:185); natively this package reads ``.vtu``
(io/vtu.py) and — with this module — Gmsh's own format, the other
de-facto standard for unstructured grids.

Supported content:
* ``$Nodes`` / ``$Elements`` in MSH 2.2 and 4.1 layouts;
* element types 2 (triangle), 3 (quad), 4 (tetrahedron) — the cell
  types of the framework; points/lines (boundary markup) are skipped;
* ``$NodeData`` / ``$ElementData`` scalar fields -> point/cell data
  (the Gmsh analogue of the VTU ``PointData``/``CellData`` the
  converter forwards, convert_to_binary.py:202-224).

By default only the highest-dimensional element blocks are kept:
Gmsh files routinely carry boundary faces alongside volume cells, and
those faces are markup, not cells (a mixed same-dimension file still
fails downstream with the reference's mixed-cell-types error,
convert_to_binary.py:187-188).
"""

from __future__ import annotations

import numpy as np

from .vtu import CellBlock, Mesh

# Gmsh element type id -> (our cell type, n_nodes, dimension)
_GMSH_CELL_TYPES = {
    2: ("triangle", 3, 2),
    3: ("quad", 4, 2),
    4: ("tetra", 4, 3),
}


def _section_lines(lines, start, name):
    """Lines of a $name section, and the index after $EndName."""
    end = f"$End{name}"
    out = []
    i = start
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line == end:
            return out, i
        out.append(line)
    raise ValueError(f"Unterminated ${name} section in .msh file")


def _parse_nodes_v2(body):
    n = int(body[0])
    # one bulk conversion instead of per-token float() (the vtk_legacy
    # bulk-parse pattern; per-line loops cost minutes at millions of
    # nodes)
    rows = np.array(
        [line.split()[:4] for line in body[1 : 1 + n]], dtype=np.float64
    )
    return rows[:, 0].astype(np.int64), rows[:, 1:4]


def _parse_nodes_v4(body):
    num_blocks = int(body[0].split()[0])
    ids_all, pts_all = [], []
    i = 1
    for _ in range(num_blocks):
        _, _, parametric, n_in_block = (int(x) for x in body[i].split())
        if parametric:
            raise ValueError("Parametric nodes are not supported")
        i += 1
        ids = np.array(body[i : i + n_in_block], dtype=np.int64)
        i += n_in_block
        pts = np.array(
            [body[i + k].split()[:3] for k in range(n_in_block)],
            dtype=np.float64,
        ).reshape(n_in_block, 3)
        i += n_in_block
        ids_all.append(ids)
        pts_all.append(pts)
    if not ids_all:
        return np.empty(0, np.int64), np.empty((0, 3), np.float64)
    return np.concatenate(ids_all), np.concatenate(pts_all)


def _parse_elements_v2(body):
    """-> {cell_type: (elem_tags, connectivity-with-gmsh-node-ids)}."""
    n = int(body[0])
    blocks = {}
    for k in range(n):
        parts = body[1 + k].split()
        etype = int(parts[1])
        if etype not in _GMSH_CELL_TYPES:
            continue
        cell_type, n_nodes, _ = _GMSH_CELL_TYPES[etype]
        n_tags = int(parts[2])
        nodes = [int(x) for x in parts[3 + n_tags : 3 + n_tags + n_nodes]]
        tags, conn = blocks.setdefault(cell_type, ([], []))
        tags.append(int(parts[0]))
        conn.append(nodes)
    return blocks


def _parse_elements_v4(body):
    num_blocks = int(body[0].split()[0])
    blocks = {}
    i = 1
    for _ in range(num_blocks):
        _, _, etype, n_in_block = (int(x) for x in body[i].split())
        i += 1
        if etype not in _GMSH_CELL_TYPES:
            i += n_in_block
            continue
        cell_type, n_nodes, _ = _GMSH_CELL_TYPES[etype]
        tags, conn = blocks.setdefault(cell_type, ([], []))
        rows = np.array(
            [body[i + k].split()[: 1 + n_nodes] for k in range(n_in_block)],
            dtype=np.int64,
        )
        tags.extend(int(t) for t in rows[:, 0])
        conn.extend(rows[:, 1:].tolist())
        i += n_in_block
    return blocks


def _parse_data_section(body):
    """$NodeData / $ElementData -> (name, {gmsh_tag: value}).

    Only scalar single-timestep fields are ingested (numComponents
    must be 1); others raise so data is never silently dropped.
    """
    i = 0
    n_str = int(body[i])
    i += 1
    name = body[i].strip().strip('"') if n_str > 0 else "unnamed"
    i += n_str
    n_real = int(body[i])
    i += 1 + n_real
    n_int = int(body[i])
    i += 1
    int_tags = [int(body[i + k]) for k in range(n_int)]
    i += n_int
    n_comp = int_tags[1] if len(int_tags) > 1 else 1
    n_vals = int_tags[2] if len(int_tags) > 2 else 0
    if n_comp != 1:
        raise ValueError(
            f"Only scalar data supported; field {name!r} has "
            f"{n_comp} components"
        )
    tags = np.empty(n_vals, dtype=np.int64)
    vals = np.empty(n_vals, dtype=np.float64)
    for k in range(n_vals):
        parts = body[i + k].split()
        tags[k] = int(parts[0])
        vals[k] = float(parts[1])
    return name, tags, vals


def _read_msh_ascii(lines, version: float):
    node_ids = points = None
    elem_blocks = {}
    node_data_raw, elem_data_raw = [], []

    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line.startswith("$") or line.startswith("$End"):
            continue
        name = line[1:]
        body, i = _section_lines(lines, i, name)
        if name == "Nodes":
            node_ids, points = (
                _parse_nodes_v2(body) if version < 3 else _parse_nodes_v4(body)
            )
        elif name == "Elements":
            elem_blocks = (
                _parse_elements_v2(body)
                if version < 3
                else _parse_elements_v4(body)
            )
        elif name == "NodeData":
            node_data_raw.append(_parse_data_section(body))
        elif name == "ElementData":
            elem_data_raw.append(_parse_data_section(body))
        # other sections ($PhysicalNames, $Entities, ...) are skipped
    return node_ids, points, elem_blocks, node_data_raw, elem_data_raw


def read_msh(filename, only_max_dim: bool = True) -> Mesh:
    """Parse a Gmsh .msh file (v2.2 / v4.1, ASCII or binary) into a Mesh.

    Args:
      filename: path to a MSH 2.2 or 4.1 file.
      only_max_dim: drop element blocks of lower dimension than the
        highest present (boundary faces/edges); set False to keep all
        supported blocks (a mixed result then fails at conversion like
        the reference, convert_to_binary.py:187-188).
    """
    with open(filename, "rb") as f:
        buf = f.read()

    version = is_binary = None
    head = buf[:256].decode("latin-1", "replace").splitlines()
    for j, line in enumerate(head):
        if line.strip() == "$MeshFormat" and j + 1 < len(head):
            parts = head[j + 1].split()
            version = float(parts[0])
            is_binary = int(parts[1]) != 0
            break
    if version is None:
        raise ValueError(f"{filename!r} has no $MeshFormat section")
    if not (2.0 <= version < 3.0 or 4.0 <= version < 5.0):
        raise ValueError(f"Unsupported .msh version {version}")
    if 4.0 <= version < 4.05:
        # MSH 4.0's $Nodes interleaves tag+coords per line; only the
        # 4.1 split layout is implemented — reject cleanly instead of
        # misparsing (re-export with Gmsh >= 4.1)
        raise ValueError("MSH 4.0 is not supported; use 4.1 or 2.2")

    if is_binary:
        parsed = _read_msh_binary(buf, version)
    else:
        parsed = _read_msh_ascii(
            buf.decode("latin-1").splitlines(), version
        )
    node_ids, points, elem_blocks, node_data_raw, elem_data_raw = parsed

    if points is None:
        raise ValueError(f"{filename!r} has no $Nodes section")
    if not elem_blocks:
        raise ValueError(f"{filename!r} has no supported cells")

    # Gmsh node tags are arbitrary (often but not always 1..n): map to rows
    id_to_row = {int(t): k for k, t in enumerate(node_ids)}

    if only_max_dim:
        max_dim = max(
            dim
            for ct, _, dim in _GMSH_CELL_TYPES.values()
            if ct in elem_blocks
        )
        elem_blocks = {
            ct: v
            for ct, v in elem_blocks.items()
            if _dim_of(ct) == max_dim
        }

    cells = []
    # gmsh element tag -> GLOBAL row over the kept blocks in cells
    # order (per-block rows would collide across blocks and silently
    # drop data for multi-block meshes)
    elem_tag_to_cell = {}
    n_cells_total = 0
    for ct, (tags, conn) in elem_blocks.items():
        data = np.array(
            [[id_to_row[t] for t in row] for row in conn], dtype=np.int64
        )
        for row, tag in enumerate(tags):
            elem_tag_to_cell[tag] = n_cells_total + row
        n_cells_total += len(data)
        cells.append(CellBlock(type=ct, data=data))

    point_data = {}
    for name, tags, vals in node_data_raw:
        col = np.zeros(len(points), dtype=np.float64)
        rows = np.array([id_to_row[int(t)] for t in tags], dtype=np.int64)
        col[rows] = vals
        point_data[name] = col

    cell_data = {}
    for name, tags, vals in elem_data_raw:
        col = np.zeros(n_cells_total, dtype=np.float64)
        for t, v in zip(tags, vals):
            row = elem_tag_to_cell.get(int(t))
            if row is not None:  # data on dropped boundary elements
                col[row] = v
        cell_data[name] = col

    return Mesh(
        points=points, cells=cells, point_data=point_data, cell_data=cell_data
    )


def _dim_of(cell_type: str) -> int:
    for ct, _, dim in _GMSH_CELL_TYPES.values():
        if ct == cell_type:
            return dim
    raise KeyError(cell_type)


# ---------------------------------------------------------------- binary

# Gmsh element type id -> node count, for skipping unsupported blocks in
# binary files (ASCII can skip by line; binary must know record widths).
_GMSH_NUM_NODES = {
    1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5, 8: 3, 9: 6, 10: 9,
    11: 10, 12: 27, 13: 18, 14: 14, 15: 1, 16: 8, 17: 20,
}


class _BinCursor:
    """Byte cursor over a binary .msh: ASCII header lines interleaved
    with raw little/big-endian blocks (record counts always known in
    advance, so sections are parsed deterministically)."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.endian = "<"

    def line(self) -> str:
        nl = self.buf.find(b"\n", self.pos)
        if nl < 0:
            out, self.pos = self.buf[self.pos :], len(self.buf)
        else:
            out, self.pos = self.buf[self.pos : nl], nl + 1
        return out.decode("latin-1").strip()

    def read(self, dtype, count: int) -> np.ndarray:
        dt = np.dtype(dtype).newbyteorder(self.endian)
        out = np.frombuffer(self.buf, dt, count, self.pos)
        if len(out) != count:
            raise ValueError("Truncated binary block in .msh file")
        self.pos += dt.itemsize * count
        return out

    def read_rec(self, fields, count: int) -> np.ndarray:
        dt = np.dtype([(n, self.endian + f, s) for n, f, s in fields])
        out = np.frombuffer(self.buf, dt, count, self.pos)
        if len(out) != count:
            raise ValueError("Truncated binary block in .msh file")
        self.pos += dt.itemsize * count
        return out


def _read_msh_binary(buf: bytes, version: float):
    """Binary MSH 2.2 / 4.1 (data-size 8; both endiannesses) -> the
    same (node_ids, points, elem_blocks, node_data, elem_data) tuple
    as :func:`_read_msh_ascii`."""
    cur = _BinCursor(buf)
    node_ids = points = None
    elem_blocks: dict = {}
    node_data_raw, elem_data_raw = [], []

    while cur.pos < len(buf):
        line = cur.line()
        if not line.startswith("$") or line.startswith("$End"):
            continue
        name = line[1:]
        if name == "MeshFormat":
            cur.line()  # version line (already parsed by read_msh)
            # binary $MeshFormat carries the int 1 for endian detection
            probe = cur.read(np.int32, 1)[0]
            if int(probe) != 1:
                cur.endian = ">"
        elif name == "Nodes":
            if version < 3:
                n = int(cur.line().split()[0])
                rec = cur.read_rec(
                    [("id", "i4", ()), ("xyz", "f8", (3,))], n
                )
                node_ids = rec["id"].astype(np.int64)
                points = rec["xyz"].astype(np.float64)
            else:
                nb, _, _, _ = (int(x) for x in cur.read(np.uint64, 4))
                ids_all, pts_all = [], []
                for _ in range(nb):
                    _, _, parametric = (int(x) for x in cur.read(np.int32, 3))
                    if parametric:
                        raise ValueError("Parametric nodes are not supported")
                    nib = int(cur.read(np.uint64, 1)[0])
                    ids_all.append(cur.read(np.uint64, nib).astype(np.int64))
                    pts_all.append(
                        cur.read(np.float64, 3 * nib).reshape(nib, 3)
                    )
                node_ids = (
                    np.concatenate(ids_all) if ids_all else np.empty(0, np.int64)
                )
                points = (
                    np.concatenate(pts_all)
                    if pts_all
                    else np.empty((0, 3), np.float64)
                )
        elif name == "Elements":
            if version < 3:
                n_total = int(cur.line().split()[0])
                done = 0
                while done < n_total:
                    etype, n_follow, n_tags = (
                        int(x) for x in cur.read(np.int32, 3)
                    )
                    nn = _GMSH_NUM_NODES.get(etype)
                    if nn is None:
                        raise ValueError(
                            f"Unknown Gmsh element type {etype} in binary file"
                        )
                    rec = cur.read_rec(
                        [
                            ("id", "i4", ()),
                            ("tags", "i4", (n_tags,)),
                            ("nodes", "i4", (nn,)),
                        ],
                        n_follow,
                    )
                    done += n_follow
                    if etype in _GMSH_CELL_TYPES:
                        ct = _GMSH_CELL_TYPES[etype][0]
                        tags, conn = elem_blocks.setdefault(ct, ([], []))
                        tags.extend(int(t) for t in rec["id"])
                        conn.extend(
                            [int(v) for v in row] for row in rec["nodes"]
                        )
            else:
                nb, _, _, _ = (int(x) for x in cur.read(np.uint64, 4))
                for _ in range(nb):
                    _, _, etype = (int(x) for x in cur.read(np.int32, 3))
                    nib = int(cur.read(np.uint64, 1)[0])
                    nn = _GMSH_NUM_NODES.get(etype)
                    if nn is None:
                        raise ValueError(
                            f"Unknown Gmsh element type {etype} in binary file"
                        )
                    rec = cur.read(np.uint64, nib * (1 + nn)).reshape(
                        nib, 1 + nn
                    )
                    if etype in _GMSH_CELL_TYPES:
                        ct = _GMSH_CELL_TYPES[etype][0]
                        tags, conn = elem_blocks.setdefault(ct, ([], []))
                        tags.extend(int(t) for t in rec[:, 0])
                        conn.extend(
                            [int(v) for v in row] for row in rec[:, 1:]
                        )
        elif name in ("NodeData", "ElementData"):
            n_str = int(cur.line())
            dname = cur.line().strip('"') if n_str > 0 else "unnamed"
            for _ in range(n_str - 1):
                cur.line()
            n_real = int(cur.line())
            for _ in range(n_real):
                cur.line()
            n_int = int(cur.line())
            int_tags = [int(cur.line()) for _ in range(n_int)]
            n_comp = int_tags[1] if len(int_tags) > 1 else 1
            n_vals = int_tags[2] if len(int_tags) > 2 else 0
            if n_comp != 1:
                raise ValueError(
                    f"Only scalar data supported; field {dname!r} has "
                    f"{n_comp} components"
                )
            rec = cur.read_rec(
                [("tag", "i4", ()), ("val", "f8", (1,))], n_vals
            )
            out = (
                node_data_raw if name == "NodeData" else elem_data_raw
            )
            out.append(
                (
                    dname,
                    rec["tag"].astype(np.int64),
                    rec["val"].reshape(-1).astype(np.float64),
                )
            )
        # other sections are ASCII-line based and fall through the
        # generic scan (their lines never start with '$')

    return node_ids, points, elem_blocks, node_data_raw, elem_data_raw
