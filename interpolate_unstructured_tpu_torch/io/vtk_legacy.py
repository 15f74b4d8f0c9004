"""Legacy VTK (.vtk) reader — the most common non-XML format the
reference ingests for free through meshio (convert_to_binary.py:185).

Self-contained reader for ``DATASET UNSTRUCTURED_GRID`` in both ASCII
and BINARY (big-endian, per the legacy spec) encodings, covering the
sections the conversion pipeline needs:

* ``POINTS n dtype``
* ``CELLS n size`` (classic count-prefixed) and the VTK>=9 split
  ``CELLS``/``OFFSETS``+``CONNECTIVITY`` layout
* ``CELL_TYPES n``
* ``POINT_DATA`` / ``CELL_DATA`` with ``SCALARS`` (+LOOKUP_TABLE),
  ``VECTORS``, and ``FIELD`` arrays

Returns the same :class:`~.vtu.Mesh` the XML reader produces, so the
converter (io/convert.py) and ``read_grid`` treat both identically.
Multi-component point/cell arrays are split into per-component
variables (``name_0``, ``name_1``, ...) since the binda data families
are per-variable 1-D columns (convert_to_binary.py:202-224).
"""

from __future__ import annotations

import re

import numpy as np

from .vtu import VTK_CELL_TYPES, CellBlock, Mesh

_VTK_TO_NP = {
    "bit": np.uint8,
    "unsigned_char": np.uint8,
    "char": np.int8,
    "unsigned_short": np.uint16,
    "short": np.int16,
    "unsigned_int": np.uint32,
    "int": np.int32,
    "unsigned_long": np.uint64,
    "long": np.int64,
    "float": np.float32,
    "double": np.float64,
    "vtkidtype": np.int64,
    "vtktypeint64": np.int64,
    "vtktypeint32": np.int32,
}


class _Scanner:
    """Token/raw-block scanner over the file payload.

    The legacy format interleaves ASCII keyword lines with (in BINARY
    mode) raw big-endian blobs that start right after a newline, so the
    scanner tracks a byte cursor and serves either whitespace tokens or
    sized binary blocks from it.
    """

    def __init__(self, buf: bytes, binary: bool):
        self.buf = buf
        self.pos = 0
        self.binary = binary

    def token(self) -> str | None:
        n = len(self.buf)
        p = self.pos
        while p < n and self.buf[p : p + 1].isspace():
            p += 1
        if p >= n:
            self.pos = p
            return None
        q = p
        while q < n and not self.buf[q : q + 1].isspace():
            q += 1
        self.pos = q
        return self.buf[p:q].decode("ascii", "replace")

    def peek(self) -> str | None:
        save = self.pos
        tok = self.token()
        self.pos = save
        return tok

    def token_same_line(self) -> str | None:
        """Next token only if it appears before the next newline; the
        cursor advances only when a token is returned.  Used for
        optional trailing fields of directive lines (SCALARS numComp)."""
        n = len(self.buf)
        p = self.pos
        while p < n and self.buf[p : p + 1] in b" \t\r":
            p += 1
        if p >= n or self.buf[p : p + 1] == b"\n":
            return None
        q = p
        while q < n and not self.buf[q : q + 1].isspace():
            q += 1
        self.pos = q
        return self.buf[p:q].decode("ascii", "replace")

    def read_array(self, count: int, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        if self.binary:
            # Raw block starts after the current line's newline
            nl = self.buf.find(b"\n", self.pos)
            if nl >= 0:
                self.pos = nl + 1
            nbytes = count * dtype.itemsize
            raw = self.buf[self.pos : self.pos + nbytes]
            if len(raw) != nbytes:
                raise ValueError("Truncated binary block in legacy VTK file")
            self.pos += nbytes
            # Legacy binary is big-endian regardless of platform
            return np.frombuffer(raw, dtype=dtype.newbyteorder(">")).astype(
                dtype
            )
        if count == 0:
            return np.empty(0, dtype=dtype)
        # Bulk parse: one C-level split bounded at `count` tokens (the
        # remainder stays one untouched chunk whose length recovers the
        # cursor), then one C-level numeric conversion — large ASCII
        # arrays would otherwise cost a Python loop per element.
        parts = self.buf[self.pos :].split(None, count)
        if len(parts) < count:
            raise ValueError("Truncated ASCII block in legacy VTK file")
        toks = parts[:count]
        self.pos = (
            len(self.buf) - len(parts[count])
            if len(parts) > count
            else len(self.buf)
        )
        try:
            return np.array(toks, dtype=dtype)
        except ValueError:
            # int arrays written with float tokens ("1.0")
            return np.array(toks, dtype=np.float64).astype(dtype)


def _np_of(name: str):
    try:
        return _VTK_TO_NP[name.lower()]
    except KeyError as err:
        raise ValueError(f"Unsupported legacy VTK dtype {name!r}") from err


def _read_attributes(sc: _Scanner, n: int, out: dict):
    """SCALARS/VECTORS/FIELD blocks of one POINT_DATA/CELL_DATA section.

    Stops (cursor untouched) at the next section keyword or EOF."""
    stop = {"POINT_DATA", "CELL_DATA", "DATASET"}
    while True:
        kw = sc.peek()
        if kw is None or kw.upper() in stop:
            return
        kw = sc.token().upper()
        if kw == "SCALARS":
            name = sc.token()
            dtype = _np_of(sc.token())
            # Optional numComp lives on the SAME line as SCALARS — the
            # following LOOKUP_TABLE line is itself optional, so a
            # line-agnostic peek would eat the first data value.
            tok = sc.token_same_line()
            ncomp = int(tok) if tok is not None else 1
            if (sc.peek() or "").upper() == "LOOKUP_TABLE":
                sc.token()
                sc.token()  # table name (only 'default' supported data-wise)
            vals = sc.read_array(n * ncomp, dtype)
            _store(out, name, vals, ncomp)
        elif kw == "VECTORS":
            name = sc.token()
            dtype = _np_of(sc.token())
            vals = sc.read_array(n * 3, dtype)
            _store(out, name, vals, 3)
        elif kw == "NORMALS" or kw == "TEXTURE_COORDINATES":
            name = sc.token()
            if kw == "TEXTURE_COORDINATES":
                ncomp = int(sc.token())
            else:
                ncomp = 3
            dtype = _np_of(sc.token())
            vals = sc.read_array(n * ncomp, dtype)
            _store(out, name, vals, ncomp)
        elif kw == "FIELD":
            sc.token()  # field name
            n_arrays = int(sc.token())
            for _ in range(n_arrays):
                name = sc.token()
                ncomp = int(sc.token())
                ntup = int(sc.token())
                dtype = _np_of(sc.token())
                vals = sc.read_array(ntup * ncomp, dtype)
                _store(out, name, vals, ncomp)
        elif kw == "LOOKUP_TABLE":
            # standalone color table: name + size, then 4 values per
            # entry — floats in ASCII, unsigned chars in BINARY mode
            # (legacy spec; reading f32 here would over-consume 12
            # bytes/entry and derail the cursor)
            sc.token()
            size = int(sc.token())
            sc.read_array(4 * size, np.uint8 if sc.binary else np.float32)
        else:
            raise ValueError(f"Unsupported legacy VTK attribute {kw!r}")


def _store(out: dict, name: str, vals: np.ndarray, ncomp: int):
    if ncomp == 1:
        out[name] = vals
    else:
        arr = vals.reshape(-1, ncomp)
        for c in range(ncomp):
            out[f"{name}_{c}"] = np.ascontiguousarray(arr[:, c])


def read_vtk(filename) -> Mesh:
    """Read a legacy .vtk UNSTRUCTURED_GRID file into a Mesh."""
    with open(filename, "rb") as f:
        buf = f.read()

    # Header: '# vtk DataFile Version x.x' | title | ASCII/BINARY
    lines = buf.split(b"\n", 3)
    if len(lines) < 4 or not lines[0].lower().startswith(b"# vtk datafile"):
        raise ValueError(f"{filename!r} is not a legacy VTK file")
    fmt = lines[2].strip().upper()
    if fmt not in (b"ASCII", b"BINARY"):
        raise ValueError(f"Unknown legacy VTK format {fmt!r}")
    body = lines[3]
    sc = _Scanner(body, binary=(fmt == b"BINARY"))

    if (sc.token() or "").upper() != "DATASET":
        raise ValueError("Expected DATASET section")
    kind = (sc.token() or "").upper()
    if kind != "UNSTRUCTURED_GRID":
        raise ValueError(
            f"Only DATASET UNSTRUCTURED_GRID is supported, got {kind}"
        )

    points = None
    conn = offsets = None
    cell_types = None
    point_data: dict = {}
    cell_data: dict = {}
    n_points = n_cells = 0

    while True:
        kw = sc.token()
        if kw is None:
            break
        kw = kw.upper()
        if kw == "POINTS":
            n_points = int(sc.token())
            dtype = _np_of(sc.token())
            points = sc.read_array(n_points * 3, dtype).astype(
                np.float64
            ).reshape(-1, 3)
        elif kw == "CELLS":
            n_cells = int(sc.token())
            size = int(sc.token())
            if (sc.peek() or "").upper() == "OFFSETS":
                # VTK >= 9 layout: CELLS n size / OFFSETS dtype ... /
                # CONNECTIVITY dtype ...  (n is offsets count = cells+1)
                sc.token()
                offsets = sc.read_array(n_cells, _np_of(sc.token())).astype(
                    np.int64
                )
                if (sc.token() or "").upper() != "CONNECTIVITY":
                    raise ValueError("OFFSETS without CONNECTIVITY")
                conn = sc.read_array(size, _np_of(sc.token())).astype(
                    np.int64
                )
                n_cells -= 1  # offsets array has n_cells+1 entries
            else:
                raw = sc.read_array(size, np.int32).astype(np.int64)
                # classic count-prefixed: [npts, i0..] per cell
                cnt0 = int(raw[0]) if size else 0
                if (
                    n_cells
                    and size == n_cells * (cnt0 + 1)
                    and (raw[:: cnt0 + 1] == cnt0).all()
                ):
                    # homogeneous mesh: one reshape, no Python loop
                    conn = np.ascontiguousarray(
                        raw.reshape(n_cells, cnt0 + 1)[:, 1:]
                    ).reshape(-1)
                    offsets = np.arange(n_cells + 1, dtype=np.int64) * cnt0
                else:
                    offsets = np.zeros(n_cells + 1, np.int64)
                    pos = 0
                    conn_parts = []
                    for c in range(n_cells):
                        cnt = int(raw[pos])
                        conn_parts.append(raw[pos + 1 : pos + 1 + cnt])
                        pos += 1 + cnt
                        offsets[c + 1] = offsets[c] + cnt
                    conn = (
                        np.concatenate(conn_parts) if conn_parts else raw[:0]
                    )
        elif kw == "CELL_TYPES":
            n = int(sc.token())
            cell_types = sc.read_array(n, np.int32)
        elif kw == "POINT_DATA":
            n = int(sc.token())
            _read_attributes(sc, n, point_data)
        elif kw == "CELL_DATA":
            n = int(sc.token())
            _read_attributes(sc, n, cell_data)
        elif kw == "METADATA":
            # skip METADATA blocks (INFORMATION ... lines) until a
            # blank line (tolerating CRLF endings)
            m = re.search(rb"\r?\n[ \t]*\r?\n", sc.buf[sc.pos :])
            sc.pos = len(sc.buf) if m is None else sc.pos + m.end()
        else:
            raise ValueError(f"Unsupported legacy VTK section {kw!r}")

    if points is None or conn is None or cell_types is None:
        raise ValueError("Legacy VTK file missing POINTS/CELLS/CELL_TYPES")

    # Group homogeneous runs by VTK type id (same contract as the XML
    # reader: the converter then rejects mixed meshes)
    cells = []
    for tid in np.unique(cell_types):
        tid = int(tid)
        if tid not in VTK_CELL_TYPES:
            raise ValueError(f"Unsupported VTK cell type id {tid}")
        name, npc = VTK_CELL_TYPES[tid]
        sel = np.flatnonzero(cell_types == tid)
        widths = offsets[sel + 1] - offsets[sel]
        if (widths != npc).any():
            raise ValueError(f"Inconsistent connectivity width for {name}")
        idx = offsets[sel][:, None] + np.arange(npc)[None, :]
        cells.append(CellBlock(type=name, data=conn[idx]))

    return Mesh(
        points=points, cells=cells, point_data=point_data,
        cell_data=cell_data,
    )
