"""Native readers for common FEM/CFD exchange formats.

The reference gets format breadth through ``meshio.read``
(convert_to_binary.py:185).  This module covers the common engineering
formats not handled by the other native readers:

* ABAQUS ``.inp``    (keyword decks; ``*NODE`` / ``*ELEMENT`` cards)
* Nastran ``.bdf``/``.nas`` (free, small- and large-field bulk data)
* AVS-UCD ``.avs``   (ASCII; includes node/cell data sections)
* SU2 ``.su2``       (CFD meshes; VTK element type ids)
* FLAC3D ``.f3grid`` (ASCII gridpoint/zone records)

All return the same :class:`~.vtu.Mesh` the converter consumes.  Like
the other readers, blocks below the file's top dimension (boundary
markup, shells next to solids) are dropped; mixed same-dimension
element types produce multiple blocks and are rejected downstream,
matching the reference's mixed-cell rejection
(convert_to_binary.py:187-188).  Node ids may be arbitrary
(non-contiguous) in every format and are remapped to 0-based order of
appearance in the node section.
"""

from __future__ import annotations

import re

import numpy as np

from .simple_formats import _face_blocks
from .vtu import CellBlock, Mesh

# our type -> spatial dimension (for top-dimension filtering)
_TYPE_DIM = {
    "vertex": 0,
    "line": 1,
    "line3": 1,
    "triangle": 2,
    "triangle6": 2,
    "quad": 2,
    "quad8": 2,
    "quad9": 2,
    "tetra": 3,
    "tetra10": 3,
    "pyramid": 3,
    "wedge": 3,
    "hexahedron": 3,
    "hexahedron20": 3,
}


def _remap_ids(ids: np.ndarray, conn: np.ndarray, what: str) -> np.ndarray:
    """Map arbitrary node ids in ``conn`` to 0-based indices into the
    node table ordered as read (``ids``)."""
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    pos = np.searchsorted(sorted_ids, conn)
    pos = np.clip(pos, 0, len(ids) - 1)
    if not np.array_equal(sorted_ids[pos], conn):
        missing = conn[sorted_ids[pos] != conn]
        raise ValueError(
            f"{what}: element references undefined node id "
            f"{int(np.ravel(missing)[0])}"
        )
    return order[pos]


def _top_dim_blocks(blocks: list) -> list:
    """Keep only the highest-dimensional CellBlocks (same rule as the
    MEDIT/Gmsh readers)."""
    if not blocks:
        raise ValueError("no elements found")
    dims = [_TYPE_DIM.get(b.type, 3) for b in blocks]
    top = max(dims)
    return [b for b, d in zip(blocks, dims) if d == top]


# ---------------------------------------------------------------- ABAQUS

# Element TYPE= prefixes -> our type.  Longest prefixes first so e.g.
# C3D10 wins over C3D1* ambiguity.  Families follow meshio's table.
_ABAQUS_TYPES = [
    ("C3D10", "tetra10"),
    ("C3D20", "hexahedron20"),
    ("C3D4", "tetra"),
    ("DC3D4", "tetra"),
    ("AC3D4", "tetra"),
    ("C3D6", "wedge"),
    ("C3D8", "hexahedron"),
    ("DC3D8", "hexahedron"),
    ("CPS3", "triangle"),
    ("CPE3", "triangle"),
    ("CPEG3", "triangle"),
    ("AC2D3", "triangle"),
    ("DC2D3", "triangle"),
    ("S3", "triangle"),
    ("STRI3", "triangle"),
    ("M3D3", "triangle"),
    ("R3D3", "triangle"),
    ("CPS4", "quad"),
    ("CPE4", "quad"),
    ("CPEG4", "quad"),
    ("AC2D4", "quad"),
    ("DC2D4", "quad"),
    ("S4", "quad"),
    ("M3D4", "quad"),
    ("R3D4", "quad"),
    ("CPS6", "triangle6"),
    ("CPE6", "triangle6"),
    ("CPS8", "quad8"),
    ("CPE8", "quad8"),
    ("T2D2", "line"),
    ("T3D2", "line"),
    ("B21", "line"),
    ("B31", "line"),
]


def _abaqus_cell_type(abq: str) -> str:
    abq = abq.upper()
    for prefix, ours in _ABAQUS_TYPES:
        if abq.startswith(prefix):
            return ours
    raise ValueError(f"Unsupported ABAQUS element type {abq!r}")


def read_abaqus(filename) -> Mesh:
    """Read an ABAQUS ``.inp`` keyword deck.

    Parses ``*NODE`` and ``*ELEMENT`` cards (data lines ending in a
    comma continue on the next line, per the ABAQUS syntax rules);
    every other keyword's data lines are skipped.  Element ids and
    ELSET/material assignments are dropped — the binda format keeps
    cells in file order (convert_to_binary.py:200-224).
    """
    with open(filename, encoding="latin-1") as f:
        lines = f.readlines()

    node_ids: list = []
    node_xyz: list = []
    # our type -> list of (n_nodes-wide) connectivity rows (raw ids)
    elems: dict = {}
    i = 0
    n_lines = len(lines)
    while i < n_lines:
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("**"):
            continue
        if not line.startswith("*"):
            continue  # stray data line outside any keyword we track
        # a keyword line ending in a comma continues on the next line
        while line.endswith(",") and i < n_lines:
            line += " " + lines[i].strip()
            i += 1
        parts = [p.strip() for p in line[1:].split(",")]
        keyword = parts[0].upper()
        params = {}
        for p in parts[1:]:
            k, _, v = p.partition("=")
            params[k.strip().upper()] = v.strip()

        if keyword == "NODE":
            pending_n: list = []
            while i < n_lines:
                data = lines[i].strip()
                if not data or data.startswith("**"):
                    i += 1
                    continue
                if data.startswith("*"):
                    break
                i += 1
                cont = data.endswith(",")
                # keep blank interior fields: an omitted data item
                # means zero in ABAQUS (trailing empties from the
                # continuation comma are dropped after the join)
                pending_n += [t.strip() for t in data.split(",")]
                if cont:
                    pending_n.pop()  # the empty token after ','
                    continue
                node_ids.append(int(pending_n[0]))
                xyz = [
                    float(t) if t else 0.0 for t in pending_n[1:4]
                ]
                xyz += [0.0] * (3 - len(xyz))
                node_xyz.append(xyz)
                pending_n = []
        elif keyword == "ELEMENT":
            ctype = _abaqus_cell_type(params.get("TYPE", ""))
            rows = elems.setdefault(ctype, [])
            pending: list = []
            while i < n_lines:
                data = lines[i].strip()
                if not data or data.startswith("**"):
                    i += 1
                    continue
                if data.startswith("*"):
                    break
                i += 1
                cont = data.endswith(",")
                pending += [int(t) for t in data.split(",") if t.strip()]
                if not cont:
                    rows.append(pending[1:])  # drop the element id
                    pending = []
            if pending:
                rows.append(pending[1:])
        # other keywords: the loop skips their data lines naturally
        # (they don't start with '*', so the outer scan passes them by)

    if not node_ids:
        raise ValueError(f"{filename}: no *NODE section")
    ids = np.asarray(node_ids, dtype=np.int64)
    points = np.asarray(node_xyz, dtype=np.float64)

    blocks = []
    for ctype, rows in elems.items():
        widths = {len(r) for r in rows}
        if len(widths) != 1:
            raise ValueError(
                f"{filename}: inconsistent node counts for {ctype} elements"
            )
        conn = np.asarray(rows, dtype=np.int64)
        blocks.append(
            CellBlock(
                type=ctype, data=_remap_ids(ids, conn, filename)
            )
        )
    return Mesh(points=points, cells=_top_dim_blocks(blocks))


# --------------------------------------------------------------- Nastran

_NASTRAN_CARDS = {
    # card name -> (our type, n grid points); grids start at field 3
    # (after EID, PID)
    "CTRIA3": ("triangle", 3),
    "CTRIA6": ("triangle6", 6),
    "CQUAD4": ("quad", 4),
    "CQUAD8": ("quad8", 8),
    "CTETRA": ("tetra", 4),  # 10-node variant upgraded to tetra10 below
    "CHEXA": ("hexahedron", 8),
    "CPENTA": ("wedge", 6),
    "CPYRAM": ("pyramid", 5),
    "CROD": ("line", 2),
    "CBAR": ("line", 2),
    "CBEAM": ("line", 2),
}

_NASTRAN_FLOAT = re.compile(r"([0-9.])([+-])(\d)")


def _nastran_float(tok: str) -> float:
    """Nastran floats may elide the exponent letter: ``1.2-3`` means
    1.2e-3 (and ``D`` exponents mean ``E``)."""
    tok = tok.strip().upper().replace("D", "E")
    if "E" not in tok:
        tok = _NASTRAN_FLOAT.sub(r"\1E\2\3", tok, count=1)
    return float(tok)


def _nastran_fields(line: str) -> list:
    """Split one physical line into fields (free, small or large field)."""
    if "," in line:
        return [f.strip() for f in line.split(",")]
    name = line[:8].strip()
    if name.endswith("*") or line[:1] == "*":
        # large field: 8-char field 1, then four 16-char fields
        fields = [name]
        body = line[8:72]
        for j in range(0, len(body), 16):
            fields.append(body[j : j + 16].strip())
        return fields
    # small field: nine 8-char columns
    return [line[j : j + 8].strip() for j in range(0, min(len(line), 72), 8)]


def read_nastran(filename) -> Mesh:
    """Read a Nastran bulk-data file (``.bdf``/``.nas``/``.fem``).

    Handles free-field (comma), small-field (8-char columns) and
    large-field (``GRID*``) cards, continuation lines (leading ``+``,
    ``*`` or blank field 1), ``$`` comments and exponent-less floats.
    Only GRID and element cards are used; everything else (case
    control, properties, materials) is skipped.
    """
    with open(filename, encoding="latin-1") as f:
        raw_lines = f.readlines()

    # Assemble logical cards: continuations append their fields 2..9.
    cards: list = []
    for line in raw_lines:
        line = line.rstrip("\n")
        dollar = line.find("$")
        if dollar != -1:
            line = line[:dollar]
        if not line.strip():
            continue
        upper = line.upper()
        if upper.startswith(("BEGIN BULK", "ENDDATA", "CEND")):
            continue
        fields = _nastran_fields(line)
        first = fields[0]
        # Parent card names START alphabetic (large-field names END
        # with '*', e.g. "GRID*"); continuations START with '+'/'*'
        # or have a blank field 1.
        is_cont = first == "" or first.startswith(("+", "*"))
        if is_cont and cards:
            cards[-1].extend(fields[1:])
        else:
            name = first.rstrip("*").upper()
            cards.append([name] + fields[1:])

    node_ids: list = []
    node_xyz: list = []
    elems: dict = {}
    for card in cards:
        name = card[0]
        if name == "GRID":
            # GRID, ID, CP, X1, X2, X3
            node_ids.append(int(card[1]))
            xyz = [
                _nastran_float(card[k]) if k < len(card) and card[k] else 0.0
                for k in (3, 4, 5)
            ]
            node_xyz.append(xyz)
        elif name in _NASTRAN_CARDS:
            ctype, n_grid = _NASTRAN_CARDS[name]
            toks = [t for t in card[3:] if t]
            if name == "CTETRA" and len(toks) >= 10:
                ctype, n_grid = "tetra10", 10
            if len(toks) < n_grid:
                raise ValueError(
                    f"{filename}: {name} card with {len(toks)} grid points"
                )
            elems.setdefault(ctype, []).append(
                [int(t) for t in toks[:n_grid]]
            )

    if not node_ids:
        raise ValueError(f"{filename}: no GRID cards")
    ids = np.asarray(node_ids, dtype=np.int64)
    points = np.asarray(node_xyz, dtype=np.float64)
    blocks = [
        CellBlock(
            type=ctype,
            data=_remap_ids(
                ids, np.asarray(rows, dtype=np.int64), filename
            ),
        )
        for ctype, rows in elems.items()
    ]
    return Mesh(points=points, cells=_top_dim_blocks(blocks))


# --------------------------------------------------------------- AVS-UCD

_AVS_TYPES = {
    "pt": ("vertex", 1),
    "line": ("line", 2),
    "tri": ("triangle", 3),
    "quad": ("quad", 4),
    "tet": ("tetra", 4),
    "pyr": ("pyramid", 5),
    "prism": ("wedge", 6),
    "hex": ("hexahedron", 8),
}

# AVS-UCD lists 3D cells in a different node order than VTK: the hex
# top face comes first, the prism top triangle first, and the pyramid
# apex first.  These permutations map file order -> VTK order (the hex
# and wedge maps are involutions).
_AVS_PERM = {
    "hexahedron": [4, 5, 6, 7, 0, 1, 2, 3],
    "wedge": [3, 4, 5, 0, 1, 2],
    "pyramid": [1, 2, 3, 4, 0],
}


def _avs_data_section(lines, pos, n_entities, entity_ids):
    """Parse one UCD data section (node or cell): component-size header
    line, ``label, unit`` lines, then one row per entity.  Vector
    components are split into per-component columns (the binda data
    families are 1-D, io/convert.py routes them per name)."""
    head = lines[pos].split()
    pos += 1
    n_comp = int(head[0])
    sizes = [int(t) for t in head[1 : 1 + n_comp]]
    labels = []
    for _ in range(n_comp):
        labels.append(lines[pos].split(",")[0].strip())
        pos += 1
    width = sum(sizes)
    vals = np.array(
        [lines[pos + k].split() for k in range(n_entities)],
        dtype=np.float64,
    ).reshape(n_entities, width + 1)
    pos += n_entities
    row_ids = vals[:, 0].astype(np.int64)
    order = _remap_ids(entity_ids, row_ids, "AVS data section")
    inv = np.empty(n_entities, dtype=np.int64)
    inv[order] = np.arange(n_entities)
    data = {}
    col = 1
    for lab, size in zip(labels, sizes):
        for c in range(size):
            name = lab if size == 1 else f"{lab}_{c}"
            data[name] = np.ascontiguousarray(vals[inv, col + c])
        col += size
    return data, pos


def read_avs(filename) -> Mesh:
    """Read an AVS-UCD ``.avs`` ASCII file (single-step variant).

    Header ``n_nodes n_cells n_ndata n_cdata n_mdata``; node and cell
    data sections (including vector components, split per column) are
    preserved; the per-cell material id becomes integer cell data
    ``avs:material`` (routed to the icell family by the converter).
    """
    with open(filename, encoding="latin-1") as f:
        lines = [
            ln
            for ln in f.read().splitlines()
            if ln.strip() and not ln.startswith("#")
        ]
    n_nodes, n_cells, n_ndata, n_cdata, _n_mdata = (
        int(t) for t in lines[0].split()[:5]
    )
    pos = 1
    vals = np.array(
        [lines[pos + k].split() for k in range(n_nodes)], dtype=np.float64
    ).reshape(n_nodes, 4)
    pos += n_nodes
    node_ids = vals[:, 0].astype(np.int64)
    points = vals[:, 1:4]

    elems: dict = {}  # our type -> (conn rows, material rows, cell ids)
    for _ in range(n_cells):
        toks = lines[pos].split()
        pos += 1
        cid = int(toks[0])
        mat = int(toks[1])
        kind = toks[2].lower()
        if kind not in _AVS_TYPES:
            raise ValueError(f"Unsupported AVS-UCD cell type {kind!r}")
        ctype, n_idx = _AVS_TYPES[kind]
        conn = [int(t) for t in toks[3 : 3 + n_idx]]
        if ctype in _AVS_PERM:
            conn = [conn[p] for p in _AVS_PERM[ctype]]
        rows = elems.setdefault(ctype, ([], [], []))
        rows[0].append(conn)
        rows[1].append(mat)
        rows[2].append(cid)

    blocks, mats, cids = [], [], []
    for ctype, (rows, mat_rows, id_rows) in elems.items():
        blocks.append(
            CellBlock(
                type=ctype,
                data=_remap_ids(
                    node_ids, np.asarray(rows, dtype=np.int64), filename
                ),
            )
        )
        mats.append(np.asarray(mat_rows, dtype=np.int32))
        cids.append(np.asarray(id_rows, dtype=np.int64))
    dims = [_TYPE_DIM.get(b.type, 3) for b in blocks]
    top = max(dims)
    keep = [d == top for d in dims]
    kept = [b for b, k in zip(blocks, keep) if k]
    cell_data = {
        "avs:material": np.concatenate(
            [m for m, k in zip(mats, keep) if k]
        )
    }

    point_data = {}
    if n_ndata:
        point_data, pos = _avs_data_section(lines, pos, n_nodes, node_ids)
    if n_cdata:
        if not all(keep):
            raise ValueError(
                f"{filename}: cell data with mixed-dimension cells is "
                "not supported"
            )
        cdata, pos = _avs_data_section(
            lines, pos, n_cells, np.concatenate(cids)
        )
        cell_data.update(cdata)
    return Mesh(
        points=points,
        cells=kept,
        point_data=point_data,
        cell_data=cell_data,
    )


# ------------------------------------------------------------------- SU2

_SU2_TYPES = {
    3: ("line", 2),
    5: ("triangle", 3),
    9: ("quad", 4),
    10: ("tetra", 4),
    12: ("hexahedron", 8),
    13: ("wedge", 6),
    14: ("pyramid", 5),
}


def read_su2(filename) -> Mesh:
    """Read an SU2 ``.su2`` mesh (VTK element type ids; NDIME/NELEM/
    NPOIN sections).  Boundary markers (NMARK) are surface markup and
    are skipped, matching the top-dimension rule."""
    with open(filename, encoding="latin-1") as f:
        lines = [
            ln.split("%")[0].strip()
            for ln in f.read().splitlines()
        ]
    lines = [ln for ln in lines if ln]

    dim = 3
    elems: dict = {}
    points = None
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        key, _, val = line.partition("=")
        key = key.strip().upper()
        if key == "NDIME":
            dim = int(val)
        elif key == "NELEM":
            n = int(val)
            for _ in range(n):
                toks = lines[i].split()
                i += 1
                vtk = int(toks[0])
                if vtk not in _SU2_TYPES:
                    raise ValueError(
                        f"Unsupported SU2 element type {vtk}"
                    )
                ctype, n_idx = _SU2_TYPES[vtk]
                elems.setdefault(ctype, []).append(
                    [int(t) for t in toks[1 : 1 + n_idx]]
                )
        elif key == "NPOIN":
            n = int(val.split()[0])
            rows = []
            for _ in range(n):
                toks = lines[i].split()
                i += 1
                rows.append([float(t) for t in toks[:dim]])
            points = np.asarray(rows, dtype=np.float64)
        elif key == "NMARK":
            # NMARK= m, then per marker MARKER_TAG / MARKER_ELEMS +
            # element lines — all consumed by the key-driven scan
            # (they parse as MARKER_* keys or element lines we skip)
            continue
        # MARKER_TAG and unrecognized lines: skip
        elif key == "MARKER_ELEMS":
            i += int(val)  # skip the boundary element lines

    if points is None:
        raise ValueError(f"{filename}: no NPOIN section")
    if points.shape[1] < 3:
        points = np.pad(points, ((0, 0), (0, 3 - points.shape[1])))
    blocks = [
        CellBlock(type=t, data=np.asarray(rows, dtype=np.int64))
        for t, rows in elems.items()
    ]
    return Mesh(points=points, cells=_top_dim_blocks(blocks))


# ---------------------------------------------------------- Netgen (vol)


def read_netgen(filename) -> Mesh:
    """Read a Netgen ``.vol`` mesh (ASCII sections).

    ``volumeelements`` rows are ``matnr np p1..pnp`` (np=4 tets),
    ``surfaceelements`` rows ``surfnr bcnr domin domout np p1..pnp``
    (surface markup, dropped when volume elements exist), ``points``
    rows are coordinates (1-based connectivity).  The material number
    becomes integer cell data ``netgen:index``."""
    with open(filename, encoding="latin-1") as f:
        lines = [
            ln.strip()
            for ln in f.read().splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")
        ]

    points = None
    vol_rows: list = []
    surf_rows: list = []
    mat_rows: list = []
    dim = 3
    i = 0
    while i < len(lines):
        section = lines[i].lower()
        i += 1
        if section == "dimension":
            dim = int(lines[i])
            i += 1
        elif section == "points":
            n = int(lines[i])
            i += 1
            points = np.array(
                [lines[i + k].split() for k in range(n)], dtype=np.float64
            ).reshape(n, -1)[:, :dim]
            i += n
        elif section == "volumeelements":
            n = int(lines[i])
            i += 1
            for k in range(n):
                toks = [int(t) for t in lines[i + k].split()]
                if toks[1] != 4:
                    raise ValueError(
                        f"Unsupported Netgen volume element with "
                        f"{toks[1]} points (only linear tets)"
                    )
                mat_rows.append(toks[0])
                vol_rows.append(toks[2:6])
            i += n
        elif section == "surfaceelements":
            n = int(lines[i])
            i += 1
            for k in range(n):
                toks = [int(t) for t in lines[i + k].split()]
                np_surf = toks[4]
                if np_surf not in (3, 4):
                    raise ValueError(
                        f"Unsupported Netgen surface element with "
                        f"{np_surf} points"
                    )
                surf_rows.append((np_surf, toks[5 : 5 + np_surf]))
            i += n
        # other sections (edgesegments, face descriptors, mesh3d
        # header, geomtype, ...) are skipped by the scan

    if points is None:
        raise ValueError(f"{filename}: no points section")
    if points.shape[1] < 3:
        points = np.pad(points, ((0, 0), (0, 3 - points.shape[1])))
    cell_data = {}
    if vol_rows:
        blocks = [
            CellBlock(
                type="tetra",
                data=np.asarray(vol_rows, dtype=np.int64) - 1,
            )
        ]
        cell_data["netgen:index"] = np.asarray(mat_rows, dtype=np.int32)
    elif surf_rows:
        blocks = _face_blocks(
            [[p - 1 for p in conn] for _, conn in surf_rows]
        )
    else:
        raise ValueError(f"{filename}: no elements")
    return Mesh(points=points, cells=blocks, cell_data=cell_data)


# ---------------------------------------------------------- Gambit (neu)

_GAMBIT_TYPES = {
    # NTYPE code -> our type (node counts are the linear ones; the
    # higher-order variants repeat the code with a larger NDP and are
    # rejected below)
    1: ("line", 2),
    2: ("quad", 4),
    3: ("triangle", 3),
    4: ("hexahedron", 8),
    5: ("wedge", 6),
    6: ("tetra", 4),
    7: ("pyramid", 5),
}

# Gambit numbers brick and pyramid nodes in tensor ("binary") order —
# bottom face 1,2,4,3 in VTK terms — not the VTK cyclic order.  These
# permutations map file order -> VTK order.
_GAMBIT_PERM = {
    "hexahedron": [0, 1, 3, 2, 4, 5, 7, 6],
    "pyramid": [0, 1, 3, 2, 4],
}


def read_gambit(filename) -> Mesh:
    """Read a Gambit neutral ``.neu`` file (Fluent ecosystem).

    Parses the NODAL COORDINATES and ELEMENTS/CELLS sections; element
    groups and boundary-condition sets are skipped.  Only the linear
    node counts per NTYPE are supported."""
    with open(filename, encoding="latin-1") as f:
        lines = f.read().splitlines()

    node_ids: list = []
    node_xyz: list = []
    elems: dict = {}
    ndim = 3
    i = 0
    while i < len(lines):
        header = lines[i].strip().upper()
        i += 1
        if header.startswith("CONTROL INFO"):
            # counts line follows the NUMNP header row; NDFCD (5th
            # number) is the dimensionality
            while i < len(lines):
                ln = lines[i].strip().upper()
                i += 1
                if ln.startswith("ENDOFSECTION"):
                    break
                if ln.startswith("NUMNP"):
                    counts = lines[i].split()
                    i += 1
                    if len(counts) >= 5:
                        ndim = int(counts[4])
        elif header.startswith("NODAL COORDINATES"):
            while i < len(lines):
                ln = lines[i].strip()
                i += 1
                if ln.upper().startswith("ENDOFSECTION"):
                    break
                toks = ln.split()
                node_ids.append(int(toks[0]))
                xyz = [float(t) for t in toks[1 : 1 + ndim]]
                xyz += [0.0] * (3 - len(xyz))
                node_xyz.append(xyz)
        elif header.startswith("ELEMENTS/CELLS"):
            # token stream: id ntype ndp n1..n_ndp (continuation lines
            # just add tokens)
            tokens: list = []
            while i < len(lines):
                ln = lines[i].strip()
                i += 1
                if ln.upper().startswith("ENDOFSECTION"):
                    break
                tokens += ln.split()
            pos = 0
            while pos < len(tokens):
                ntype = int(tokens[pos + 1])
                ndp = int(tokens[pos + 2])
                if ntype not in _GAMBIT_TYPES:
                    raise ValueError(
                        f"Unsupported Gambit element type {ntype}"
                    )
                ctype, n_linear = _GAMBIT_TYPES[ntype]
                if ndp != n_linear:
                    raise ValueError(
                        f"Unsupported Gambit {ctype} with {ndp} nodes "
                        f"(only the linear {n_linear}-node form)"
                    )
                conn = [int(t) for t in tokens[pos + 3 : pos + 3 + ndp]]
                pos += 3 + ndp
                if ctype in _GAMBIT_PERM:
                    conn = [conn[p] for p in _GAMBIT_PERM[ctype]]
                elems.setdefault(ctype, []).append(conn)
        elif header and not header.startswith(("**", "ENDOFSECTION")):
            # unknown section: skip to its ENDOFSECTION
            while i < len(lines):
                if lines[i].strip().upper().startswith("ENDOFSECTION"):
                    i += 1
                    break
                i += 1

    if not node_ids:
        raise ValueError(f"{filename}: no NODAL COORDINATES section")
    ids = np.asarray(node_ids, dtype=np.int64)
    points = np.asarray(node_xyz, dtype=np.float64)
    blocks = [
        CellBlock(
            type=ctype,
            data=_remap_ids(
                ids, np.asarray(rows, dtype=np.int64), filename
            ),
        )
        for ctype, rows in elems.items()
    ]
    return Mesh(points=points, cells=_top_dim_blocks(blocks))


# --------------------------------------------------------------- Tecplot

_TECPLOT_ZONES = {
    # ET= (classic) and ZONETYPE= (modern) spellings
    "TRIANGLE": ("triangle", 3),
    "FETRIANGLE": ("triangle", 3),
    "QUADRILATERAL": ("quad", 4),
    "FEQUADRILATERAL": ("quad", 4),
    "TETRAHEDRON": ("tetra", 4),
    "FETETRAHEDRON": ("tetra", 4),
    "BRICK": ("hexahedron", 8),
    "FEBRICK": ("hexahedron", 8),
}

_TECPLOT_KV = re.compile(
    r"([A-Za-z]+)\s*=\s*(\"[^\"]*\"|\([^)]*\)|[^\s,]+)"
)


def read_tecplot(filename) -> Mesh:
    """Read a Tecplot ASCII file (``.dat``/``.tec``) with one
    finite-element zone.

    Supports classic (``F=FEPOINT``/``FEBLOCK``, ``ET=``) and modern
    (``ZONETYPE=``, ``DATAPACKING=``) zone headers, POINT and BLOCK
    packing, and ``VARLOCATION=([k]=CELLCENTERED)`` cell-centered
    variables (which become cell data).  The variables named X/Y/Z
    (case-insensitive) are the coordinates; every other variable
    becomes point data (or cell data when cell-centered).
    """
    with open(filename, encoding="latin-1") as f:
        lines = [
            ln
            for ln in f.read().splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")
        ]

    variables: list = []
    zone_params: dict = {}
    data_tokens: list = []
    i = 0
    while i < len(lines):
        line = lines[i]
        stripped = line.strip()
        upper = stripped.upper()
        if upper.startswith("TITLE"):
            i += 1
        elif upper.startswith("VARIABLES"):
            # names continue across lines until ZONE (quoted or bare)
            buf = stripped.split("=", 1)[1]
            i += 1
            while i < len(lines) and not lines[i].strip().upper().startswith(
                "ZONE"
            ):
                buf += " " + lines[i].strip()
                i += 1
            variables = re.findall(r'"([^"]*)"|([^\s,]+)', buf)
            variables = [a or b for a, b in variables]
        elif upper.startswith("ZONE"):
            if zone_params:
                raise ValueError(
                    f"{filename}: multiple Tecplot zones are not supported"
                )
            # the zone header spans lines while they contain '='
            buf = stripped[4:]
            i += 1
            while i < len(lines) and "=" in lines[i]:
                buf += " " + lines[i].strip()
                i += 1
            for k, v in _TECPLOT_KV.findall(buf):
                zone_params[k.upper()] = v.strip('"')
            # the zone's data follows until the next keyword line
            while i < len(lines):
                up = lines[i].strip().upper()
                if up.startswith(("ZONE", "TITLE", "VARIABLES", "TEXT",
                                  "GEOMETRY", "DATASETAUX")):
                    break
                data_tokens += lines[i].split()
                i += 1
        else:
            i += 1

    if not variables:
        raise ValueError(f"{filename}: no VARIABLES line")
    if not zone_params:
        raise ValueError(f"{filename}: no ZONE header")
    n_node = int(zone_params.get("N") or zone_params.get("NODES") or 0)
    n_elem = int(zone_params.get("E") or zone_params.get("ELEMENTS") or 0)
    if not n_node or not n_elem:
        raise ValueError(f"{filename}: zone is missing N=/E= counts")
    et = (
        zone_params.get("ET") or zone_params.get("ZONETYPE") or ""
    ).upper()
    if et not in _TECPLOT_ZONES:
        raise ValueError(f"Unsupported Tecplot zone type {et!r}")
    ctype, n_idx = _TECPLOT_ZONES[et]
    # Packing default depends on the header style: classic F= defaults
    # to POINT, the modern DATAPACKING= keyword defaults to BLOCK.
    if "F" in zone_params:
        packing = zone_params["F"].upper()
    elif "DATAPACKING" in zone_params:
        packing = zone_params["DATAPACKING"].upper()
    else:
        packing = "BLOCK" if "ZONETYPE" in zone_params else "POINT"
    block = packing in ("FEBLOCK", "BLOCK")

    # cell-centered variable indices (1-based in the file syntax):
    # VARLOCATION=([4]=CELLCENTERED,[1-3]=NODAL) — only the ranges
    # assigned to CELLCENTERED count (NODAL ranges must not match)
    centered = set()
    varloc = zone_params.get("VARLOCATION", "")
    for ranges in re.findall(
        r"\[([\d\s,\-]+)\]\s*=\s*CELLCENTERED", varloc, re.IGNORECASE
    ):
        for lo, hi in re.findall(r"(\d+)(?:\s*-\s*(\d+))?", ranges):
            lo = int(lo)
            hi = int(hi) if hi else lo
            centered.update(range(lo - 1, hi))
    if centered and not block:
        raise ValueError(
            f"{filename}: CELLCENTERED variables require BLOCK packing"
        )

    nvar = len(variables)
    cols = []
    pos = 0
    if block:
        for k in range(nvar):
            n = n_elem if k in centered else n_node
            cols.append(
                np.array(data_tokens[pos : pos + n], dtype=np.float64)
            )
            pos += n
    else:
        vals = np.array(
            data_tokens[: n_node * nvar], dtype=np.float64
        ).reshape(n_node, nvar)
        cols = [vals[:, k] for k in range(nvar)]
        pos = n_node * nvar
    conn = np.array(
        data_tokens[pos : pos + n_elem * n_idx], dtype=np.int64
    ).reshape(n_elem, n_idx) - 1

    upper_names = [v.upper() for v in variables]
    points = np.zeros((n_node, 3))
    coord_idx = set()
    for axis, nm in enumerate("XYZ"):
        if nm in upper_names:
            k = upper_names.index(nm)
            coord_idx.add(k)
            points[:, axis] = cols[k]
    if not coord_idx:
        raise ValueError(f"{filename}: no X/Y/Z coordinate variables")

    point_data, cell_data = {}, {}
    for k, name in enumerate(variables):
        if k in coord_idx:
            continue
        (cell_data if k in centered else point_data)[name] = cols[k]
    return Mesh(
        points=points,
        cells=[CellBlock(type=ctype, data=conn)],
        point_data=point_data,
        cell_data=cell_data,
    )


# ----------------------------------------------------------------- UGRID


def read_ugrid(filename) -> Mesh:
    """Read an AFLR3 ``.ugrid`` volume mesh.

    Layout: header ``nnodes ntria nquad ntet npyr nprism nhex``, node
    coordinates, boundary tria/quad connectivity, one surface tag per
    boundary face, then the volume elements.  All connectivity is
    1-based.  Boundary faces are surface markup (dropped when volume
    elements exist, like the other readers' top-dimension rule).

    The compound-suffix binary variants are supported: ``.b8.ugrid``
    (big-endian, float64 coords), ``.lb8.ugrid`` (little-endian
    float64), ``.b4``/``.lb4`` (float32); ints are int32 in all of
    them.  Plain ``.ugrid`` is ASCII.
    """
    name = str(filename).lower()
    flavor = None
    for suffix, (endian, fdtype) in {
        ".b8.ugrid": (">", ">f8"),
        ".lb8.ugrid": ("<", "<f8"),
        ".b4.ugrid": (">", ">f4"),
        ".lb4.ugrid": ("<", "<f4"),
    }.items():
        if name.endswith(suffix):
            flavor = (endian, fdtype)
    if flavor is not None:
        return _read_ugrid_binary(filename, *flavor)

    with open(filename, encoding="latin-1") as f:
        tokens = f.read().split()
    (n_node, n_tri, n_quad, n_tet, n_pyr, n_prz, n_hex) = (
        int(t) for t in tokens[:7]
    )
    pos = 7
    points = np.array(
        tokens[pos : pos + 3 * n_node], dtype=np.float64
    ).reshape(n_node, 3)
    pos += 3 * n_node

    def block(n, width):
        nonlocal pos
        conn = np.array(
            tokens[pos : pos + n * width], dtype=np.int64
        ).reshape(n, width) - 1
        pos += n * width
        return conn

    tri = block(n_tri, 3)
    quad = block(n_quad, 4)
    pos += n_tri + n_quad  # surface tags
    tet = block(n_tet, 4)
    pyr = block(n_pyr, 5)
    prz = block(n_prz, 6)
    hexa = block(n_hex, 8)

    return _ugrid_mesh(points, tri, quad, tet, pyr, prz, hexa)


def _ugrid_mesh(points, tri, quad, tet, pyr, prz, hexa) -> Mesh:
    if len(pyr):
        # AFLR3 orders the 5 pyramid nodes differently from VTK and no
        # authoritative mapping is bundled here — reject rather than
        # emit silently wrong connectivity (tet/prism/hex pass through
        # unchanged; their UGRID order matches VTK).
        raise ValueError(
            "UGRID pyramid elements are not supported (node ordering)"
        )
    blocks = []
    for ctype, conn in (
        ("triangle", tri),
        ("quad", quad),
        ("tetra", tet),
        ("pyramid", pyr),
        ("wedge", prz),
        ("hexahedron", hexa),
    ):
        if len(conn):
            blocks.append(CellBlock(type=ctype, data=conn))
    return Mesh(points=points, cells=_top_dim_blocks(blocks))


def _read_ugrid_binary(filename, endian: str, fdtype: str) -> Mesh:
    """Raw (stream, no Fortran record markers) binary UGRID: the
    ASCII layout with int32 counts/connectivity/tags and float coords
    of the flavor's width/endianness."""
    idt = np.dtype(endian + "i4")
    fdt = np.dtype(fdtype)
    with open(filename, "rb") as f:
        buf = f.read()
    header = np.frombuffer(buf, idt, count=7)
    n_node, n_tri, n_quad, n_tet, n_pyr, n_prz, n_hex = (
        int(v) for v in header
    )
    off = 7 * idt.itemsize
    points = np.frombuffer(buf, fdt, count=3 * n_node, offset=off)
    points = points.reshape(n_node, 3).astype(np.float64)
    off += 3 * n_node * fdt.itemsize

    def block(n, width):
        nonlocal off
        conn = np.frombuffer(buf, idt, count=n * width, offset=off)
        off += n * width * idt.itemsize
        return conn.reshape(n, width).astype(np.int64) - 1

    tri = block(n_tri, 3)
    quad = block(n_quad, 4)
    off += (n_tri + n_quad) * idt.itemsize  # surface tags
    tet = block(n_tet, 4)
    pyr = block(n_pyr, 5)
    prz = block(n_prz, 6)
    hexa = block(n_hex, 8)
    return _ugrid_mesh(points, tri, quad, tet, pyr, prz, hexa)


# ---------------------------------------------------------------- FLAC3D

# Only T4 zones are supported: FLAC3D's B8/W6/P5 gridpoint numbering
# differs from VTK's and no authoritative mapping is bundled here —
# emitting unpermuted connectivity would be silently wrong, so those
# zone types are rejected instead.
_FLAC3D_ZONES = {
    "T4": ("tetra", 4),
}


def read_flac3d(filename) -> Mesh:
    """Read a FLAC3D ``.f3grid`` ASCII grid.

    ``G id x y z`` gridpoints, ``Z <TYPE> id g1..gn`` zones; ``ZGROUP``
    sections become integer cell data ``flac3d:zgroup`` (group index in
    file order; zones not in any group get -1)."""
    node_ids: list = []
    node_xyz: list = []
    zone_ids: dict = {}  # our type -> list of zone ids (file order)
    elems: dict = {}
    groups: list = []  # (group index, [zone ids])
    with open(filename, encoding="latin-1") as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("*"):
            continue
        toks = line.split()
        tag = toks[0].upper()
        if tag in ("G", "GRIDPOINT"):
            node_ids.append(int(toks[1]))
            node_xyz.append([float(t) for t in toks[2:5]])
        elif tag in ("Z", "ZONE"):
            kind = toks[1].upper()
            if kind not in _FLAC3D_ZONES:
                raise ValueError(
                    f"Unsupported FLAC3D zone type {kind!r}"
                )
            ctype, n_idx = _FLAC3D_ZONES[kind]
            elems.setdefault(ctype, []).append(
                [int(t) for t in toks[3 : 3 + n_idx]]
            )
            zone_ids.setdefault(ctype, []).append(int(toks[2]))
        elif tag == "ZGROUP":
            members: list = []
            while i < len(lines):
                nxt = lines[i].strip()
                if not nxt or nxt.startswith("*"):
                    i += 1
                    continue
                first = nxt.split()[0]
                if not first.lstrip("-").isdigit():
                    break
                members += [int(t) for t in nxt.split()]
                i += 1
            groups.append(members)
        # other records (FLAC3DGRID header, F faces, ...): skipped

    if not node_ids:
        raise ValueError(f"{filename}: no gridpoints")
    ids = np.asarray(node_ids, dtype=np.int64)
    points = np.asarray(node_xyz, dtype=np.float64)
    blocks = []
    zid_cols = []
    for ctype, rows in elems.items():
        blocks.append(
            CellBlock(
                type=ctype,
                data=_remap_ids(
                    ids, np.asarray(rows, dtype=np.int64), filename
                ),
            )
        )
        zid_cols.append(np.asarray(zone_ids[ctype], dtype=np.int64))
    cell_data = {}
    if groups:
        all_zids = np.concatenate(zid_cols)
        zgroup = np.full(len(all_zids), -1, dtype=np.int32)
        for gi, members in enumerate(groups):
            zgroup[np.isin(all_zids, np.asarray(members, np.int64))] = gi
        cell_data["flac3d:zgroup"] = zgroup
    return Mesh(
        points=points, cells=_top_dim_blocks(blocks), cell_data=cell_data
    )
