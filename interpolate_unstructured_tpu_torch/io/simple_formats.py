"""Native readers for common simple mesh formats.

The reference gets format breadth for free through ``meshio.read``
(convert_to_binary.py:185), which accepts dozens of formats.  meshio is
not installed in this environment, so the most common remaining formats
get small self-contained readers here:

* MEDIT ``.mesh``  (INRIA ASCII; tet volume meshes with boundary markup)
* TetGen ``.node``/``.ele`` pairs (tet volume meshes)
* OFF  (Object File Format; tri/quad surface meshes)
* PLY  (ascii / binary little+big endian; tri/quad surface meshes)
* STL  (ascii / binary; triangle soup, duplicate vertices merged)
* OBJ  (Wavefront ASCII; tri/quad surface meshes)

All return the same :class:`~.vtu.Mesh` the converter consumes.  Like
the Gmsh reader (``msh.py``), volume formats that also carry boundary
markup (MEDIT triangles next to tetrahedra) keep only the
highest-dimensional blocks; mixed *same*-dimension files produce
multiple blocks and are rejected downstream, matching the reference's
mixed-cell rejection (convert_to_binary.py:187-188).
"""

from __future__ import annotations

import os
import re

import numpy as np

from .vtu import CellBlock, Mesh

_FACE_TYPE = {3: "triangle", 4: "quad"}


def _face_blocks(faces: list) -> list:
    """Group variable-length faces into homogeneous tri/quad CellBlocks."""
    by_size: dict = {}
    for f in faces:
        by_size.setdefault(len(f), []).append(f)
    blocks = []
    for size in sorted(by_size):
        if size not in _FACE_TYPE:
            raise ValueError(
                f"Unsupported face with {size} vertices (only triangles "
                "and quads are supported)"
            )
        blocks.append(
            CellBlock(
                type=_FACE_TYPE[size],
                data=np.asarray(by_size[size], dtype=np.int64),
            )
        )
    return blocks


# ---------------------------------------------------------------- MEDIT

_MEDIT_CELLS = {
    # keyword -> (our type, n indices, dimension)
    "edges": ("line", 2, 1),
    "triangles": ("triangle", 3, 2),
    "quadrilaterals": ("quad", 4, 2),
    "tetrahedra": ("tetra", 4, 3),
}
_MEDIT_SKIP_COUNTED = {
    # keyword -> ints per record (sections we parse past but drop)
    "corners": 1,
    "requiredvertices": 1,
    "ridges": 1,
    "requirededges": 1,
    "normals": 3,
    "tangents": 3,
}


def read_medit(filename) -> Mesh:
    """Read an INRIA MEDIT ``.mesh`` ASCII file.

    Element reference labels are kept as integer cell data named
    ``medit:ref`` (meshio's convention), which the converter routes to
    the icell_data family.  Only the highest-dimensional element
    sections become cells.
    """
    with open(filename, encoding="latin-1") as f:
        text = f.read()
    # Strip comments, then tokenize.  MEDIT allows keyword and values on
    # the same or separate lines, so a flat token stream is simplest.
    text = re.sub(r"#[^\n]*", " ", text)
    tokens = text.split()
    pos = 0

    def peek():
        return tokens[pos] if pos < len(tokens) else None

    def take():
        nonlocal pos
        t = tokens[pos]
        pos += 1
        return t

    dim = 3
    points = None
    blocks: dict = {}  # type -> (conn list, ref list, dimension)
    while pos < len(tokens):
        kw = take().lower()
        if kw == "end":
            break
        if kw == "meshversionformatted":
            take()
        elif kw == "dimension":
            dim = int(take())
        elif kw == "vertices":
            n = int(take())
            vals = np.array(
                tokens[pos : pos + n * (dim + 1)], dtype=np.float64
            ).reshape(n, dim + 1)
            pos += n * (dim + 1)
            points = vals[:, :dim]
        elif kw in _MEDIT_CELLS:
            ctype, nidx, cdim = _MEDIT_CELLS[kw]
            n = int(take())
            vals = np.array(
                tokens[pos : pos + n * (nidx + 1)], dtype=np.int64
            ).reshape(n, nidx + 1)
            pos += n * (nidx + 1)
            blocks[ctype] = (vals[:, :nidx] - 1, vals[:, nidx], cdim)
        elif kw in _MEDIT_SKIP_COUNTED:
            n = int(take())
            pos += n * _MEDIT_SKIP_COUNTED[kw]
        elif kw == "solatvertices":
            # Solution sections live in .sol files; tolerate inline ones
            # by skipping to the next keyword.
            while peek() is not None and not peek().isalpha():
                take()
        else:
            raise ValueError(f"Unsupported MEDIT section {kw!r}")

    if points is None:
        raise ValueError(f"{filename}: no Vertices section")
    if points.shape[1] < 3:
        points = np.pad(points, ((0, 0), (0, 3 - points.shape[1])))
    if not blocks:
        raise ValueError(f"{filename}: no element sections")
    max_dim = max(cdim for _, _, cdim in blocks.values())
    cells = []
    all_refs = []
    for ctype, (conn, refs, cdim) in blocks.items():
        if cdim != max_dim:
            continue  # boundary markup below the top dimension
        cells.append(CellBlock(type=ctype, data=conn))
        all_refs.append(np.asarray(refs, dtype=np.int32))
    # one column over all kept blocks, in cells order
    cell_data = {"medit:ref": np.concatenate(all_refs)}

    # A sibling .sol file carries per-vertex solution fields
    sol_path = os.path.splitext(os.fspath(filename))[0] + ".sol"
    point_data = (
        _read_medit_sol(sol_path, len(points))
        if os.path.exists(sol_path)
        else {}
    )
    return Mesh(
        points=points, cells=cells,
        point_data=point_data, cell_data=cell_data,
    )


def _read_medit_sol(filename, n_vertices: int) -> dict:
    """Companion MEDIT ``.sol`` file: per-vertex solution fields.

    Scalars become one column each; vectors/tensors are split into
    per-component columns (the binda data families are 1-D).  Field
    type codes: 1 scalar, 2 vector (dim components), 3 symmetric
    tensor (dim*(dim+1)/2 components).
    """
    with open(filename, encoding="latin-1") as f:
        text = re.sub(r"#[^\n]*", " ", f.read())
    tokens = text.split()
    pos = 0
    dim = 3
    out: dict = {}
    while pos < len(tokens):
        kw = tokens[pos].lower()
        pos += 1
        if kw == "end":
            break
        if kw == "meshversionformatted":
            pos += 1
        elif kw == "dimension":
            dim = int(tokens[pos])
            pos += 1
        elif kw == "solatvertices":
            n = int(tokens[pos])
            pos += 1
            if n != n_vertices:
                raise ValueError(
                    f".sol has {n} vertex records for {n_vertices} vertices"
                )
            n_fields = int(tokens[pos])
            pos += 1
            types = [int(tokens[pos + k]) for k in range(n_fields)]
            pos += n_fields
            ncomp = {1: 1, 2: dim, 3: dim * (dim + 1) // 2}
            widths = [ncomp[t] for t in types]
            row_w = sum(widths)
            vals = np.array(
                tokens[pos : pos + n * row_w], dtype=np.float64
            ).reshape(n, row_w)
            pos += n * row_w
            col = 0
            for fi, w in enumerate(widths):
                if w == 1:
                    out[f"medit:sol{fi}"] = vals[:, col]
                else:
                    for c in range(w):
                        out[f"medit:sol{fi}_{c}"] = vals[:, col + c]
                col += w
        else:
            raise ValueError(f"Unsupported MEDIT .sol section {kw!r}")
    return out


# --------------------------------------------------------------- TetGen


def _tetgen_rows(filename) -> list:
    with open(filename, encoding="latin-1") as f:
        rows = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append(line.split())
        return rows


def read_tetgen(filename) -> Mesh:
    """Read a TetGen ``.node``/``.ele`` pair (either path accepted).

    ``.node``: header ``n_points dim n_attrs has_marker`` then rows
    ``idx x y z [attrs...] [marker]``.  ``.ele``: header
    ``n_tets nodes_per_tet n_region_attrs`` then rows
    ``idx v1 v2 v3 v4 [region]``.  Node numbering may start at 0 or 1
    (detected from the first row).  Point attributes become point data
    ``tetgen:attr<i>``; the region attribute becomes integer cell data
    ``tetgen:ref``.
    """
    base = os.fspath(filename)
    base = base[: -len(".node")] if base.endswith(".node") else base[: -len(".ele")]
    node_rows = _tetgen_rows(base + ".node")
    ele_rows = _tetgen_rows(base + ".ele")

    n_pts, dim, n_attrs, has_marker = (int(x) for x in node_rows[0][:4])
    if dim != 3:
        raise ValueError(f"TetGen dimension {dim} not supported")
    nodes = np.array(node_rows[1 : 1 + n_pts], dtype=np.float64)
    first_index = int(nodes[0, 0])
    points = nodes[:, 1:4]
    point_data = {
        f"tetgen:attr{i}": nodes[:, 4 + i] for i in range(n_attrs)
    }

    n_tets, n_per_tet, n_region = (int(x) for x in ele_rows[0][:3])
    if n_per_tet != 4:
        raise ValueError(
            f"TetGen {n_per_tet}-node tetrahedra not supported (linear only)"
        )
    elems = np.array(ele_rows[1 : 1 + n_tets], dtype=np.float64)
    conn = elems[:, 1:5].astype(np.int64) - first_index
    cell_data = {}
    if n_region:
        cell_data["tetgen:ref"] = elems[:, 5].astype(np.int32)
    return Mesh(
        points=points,
        cells=[CellBlock(type="tetra", data=conn)],
        point_data=point_data,
        cell_data=cell_data,
    )


# ------------------------------------------------------------------ OFF


def read_off(filename) -> Mesh:
    """Read an Object File Format surface mesh (tri/quad faces)."""
    with open(filename, encoding="latin-1") as f:
        rows = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append(line)
    if not rows:
        raise ValueError(f"{filename}: empty OFF file")
    first = rows[0]
    if first.upper().startswith("OFF"):
        rest = first[3:].split()
        rows = ([" ".join(rest)] if rest else []) + rows[1:]
    nv, nf = (int(x) for x in rows[0].split()[:2])
    points = np.array(
        [r.split()[:3] for r in rows[1 : 1 + nv]], dtype=np.float64
    )
    faces = []
    for r in rows[1 + nv : 1 + nv + nf]:
        vals = r.split()
        k = int(vals[0])
        faces.append([int(v) for v in vals[1 : 1 + k]])
    return Mesh(points=points, cells=_face_blocks(faces))


# ------------------------------------------------------------------ PLY

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(filename) -> Mesh:
    """Read a PLY surface mesh (ascii / binary little+big endian).

    Vertex properties beyond x/y/z become point data under their PLY
    names; the face element must carry a ``vertex_indices`` (or
    ``vertex_index``) list property.
    """
    with open(filename, "rb") as f:
        raw = f.read()
    end = raw.find(b"end_header")
    if not raw.startswith(b"ply") or end < 0:
        raise ValueError(f"{filename}: not a PLY file")
    header = raw[:end].decode("latin-1").splitlines()
    body = raw[raw.index(b"\n", end) + 1 :]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype)] ; list props special)
    for line in header:
        parts = line.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], ("list", _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]]))
                )
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]]))
    if fmt is None:
        raise ValueError(f"{filename}: PLY header has no format line")
    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)

    data: dict = {}
    if fmt == "ascii":
        rows = body.decode("latin-1").split("\n")
        ri = 0
        for name, count, props in elements:
            if any(isinstance(d, tuple) for _, d in props):
                if len(props) != 1:
                    raise ValueError(
                        "PLY face elements with extra properties not supported"
                    )
                faces = []
                for _ in range(count):
                    vals = rows[ri].split()
                    ri += 1
                    k = int(vals[0])
                    faces.append([int(v) for v in vals[1 : 1 + k]])
                data[name] = faces
            else:
                table = np.array(
                    [rows[ri + j].split() for j in range(count)],
                    dtype=np.float64,
                )
                ri += count
                data[name] = {p: table[:, i] for i, (p, _) in enumerate(props)}
    else:
        off = 0
        for name, count, props in elements:
            if any(isinstance(d, tuple) for _, d in props):
                if len(props) != 1:
                    raise ValueError(
                        "PLY face elements with extra properties not supported"
                    )
                _, (_, cnt_t, idx_t) = props[0]
                cnt_dt = np.dtype(endian + cnt_t)
                idx_dt = np.dtype(endian + idx_t)
                faces = []
                for _ in range(count):
                    k = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    faces.append(
                        np.frombuffer(body, idx_dt, k, off).astype(np.int64)
                    )
                    off += k * idx_dt.itemsize
                data[name] = faces
            else:
                rec = np.dtype([(p, endian + d) for p, d in props])
                table = np.frombuffer(body, rec, count, off)
                off += rec.itemsize * count
                data[name] = {p: table[p].astype(np.float64) for p, _ in props}

    if "vertex" not in data or "face" not in data:
        raise ValueError(f"{filename}: PLY needs vertex and face elements")
    verts = data["vertex"]
    points = np.column_stack([verts["x"], verts["y"], verts["z"]])
    point_data = {
        p: v for p, v in verts.items() if p not in ("x", "y", "z")
    }
    return Mesh(
        points=points,
        cells=_face_blocks([list(f) for f in data["face"]]),
        point_data=point_data,
    )


# ------------------------------------------------------------------ STL


def read_stl(filename) -> Mesh:
    """Read an STL triangle mesh (ascii or binary).

    STL stores an unshared vertex triple per facet; duplicates are
    merged exactly (``np.unique``) so the result is a connected mesh the
    walk's face adjacency can traverse.
    """
    with open(filename, "rb") as f:
        raw = f.read()
    tri_verts = None
    if raw[:5].lower() == b"solid":
        vals = re.findall(
            rb"vertex\s+(\S+)\s+(\S+)\s+(\S+)", raw, flags=re.IGNORECASE
        )
        if vals:
            tri_verts = np.array(vals, dtype=np.float64)
    if tri_verts is None:
        # Binary: 80-byte header, uint32 count, then 50-byte records of
        # (normal 3f4, vertices 9f4, attribute u2).
        (n,) = np.frombuffer(raw, "<u4", 1, 80)
        rec = np.dtype(
            [("normal", "<f4", 3), ("verts", "<f4", (3, 3)), ("attr", "<u2")]
        )
        facets = np.frombuffer(raw, rec, int(n), 84)
        tri_verts = facets["verts"].reshape(-1, 3).astype(np.float64)
    if len(tri_verts) % 3:
        raise ValueError(f"{filename}: vertex count not a multiple of 3")
    points, inverse = np.unique(tri_verts, axis=0, return_inverse=True)
    conn = inverse.reshape(-1, 3).astype(np.int64)
    return Mesh(points=points, cells=[CellBlock(type="triangle", data=conn)])


# ------------------------------------------------------------------ OBJ


def read_obj(filename) -> Mesh:
    """Read a Wavefront OBJ surface mesh (v/f records; tri/quad faces).

    Texture/normal slots in face tokens (``v/vt/vn``) and negative
    (relative) indices are handled; other record types are skipped.
    """
    points = []
    faces = []
    with open(filename, encoding="latin-1") as f:
        for line in f:
            parts = line.split("#", 1)[0].split()
            if not parts:
                continue
            if parts[0] == "v":
                points.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/", 1)[0])
                    idx.append(i - 1 if i > 0 else len(points) + i)
                faces.append(idx)
    if not points or not faces:
        raise ValueError(f"{filename}: no v/f records found")
    return Mesh(
        points=np.asarray(points, dtype=np.float64),
        cells=_face_blocks(faces),
    )
