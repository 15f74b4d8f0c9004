"""The port's mesh input and output against the JAX package's.

Every case writes its input file inside the test, with the generators of
the JAX package's own reader tests (``tests/test_io.py``,
``test_vtk_legacy.py``, ``test_msh.py``, ``test_simple_formats.py``,
``test_fem_formats.py``, ``test_xdmf_exodus.py``); both packages read it
and must give equal ``Mesh`` objects, array for array and dtype for
dtype.  Written files (binda containers, the converter's output,
``write_vtk`` and ``write_trace_vtk``) must be byte-identical, and each
package must read the other's.  ``read_grid`` builds the same host
leaves in both packages and answers queries within the tolerances of
``tests/test_torch_slice.py``.  All comparisons are exact unless a case
says otherwise.

Left out on purpose (ROADMAP C3, faults that both packages share and
that no test may pin as correct): AVS-UCD tetrahedra (``_AVS_PERM`` has
no tetra permutation, so they come out inverted), an ABAQUS element row
that ends in a dangling continuation (truncated), and Nastran CHEXA20 /
CPENTA15 cards (truncated to their linear corners).  The AVS reader is
covered by the hexahedron input instead, and the cross-format mesh
without its AVS file.
"""

import base64
import dataclasses
import filecmp
import importlib
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import interpolate_unstructured_tpu_torch as tiu
from interpolate_unstructured_tpu_torch.io import binda as tbinda
from interpolate_unstructured_tpu_torch.io import convert as tconvert
from interpolate_unstructured_tpu_torch.utils import meshgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = tiu.IUConfig(cand_build="host")


def _jax():
    """The JAX package and jax.numpy (the reference side)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import interpolate_unstructured_tpu as jiu

    return jnp, jiu


def _jtest(name):
    """One of the JAX package's own test modules, for its generators."""
    _jax()
    return importlib.import_module(name)


# ---------------------------------------------------------------------------
# Reader inputs: name -> writer(tmp_path) -> path of the file to read
# ---------------------------------------------------------------------------


def _point_data(pts):
    return {"Polynomial": pts.sum(1) + 1.0, "XY": pts[:, 0] * pts[:, 1]}


def _vtu_raw(tmp):
    """Appended raw encoding, the writer of both packages."""
    _jax()
    from interpolate_unstructured_tpu.io.vtk import write_vtu

    pts, cells, _ = meshgen.tet_box_mesh(3, 3, 3)
    p = tmp / "box.vtu"
    write_vtu(p, pts, cells, "tetra", point_data=_point_data(pts),
              cell_data={"vol": np.linspace(0.5, 1.5, len(cells))},
              icell_data={"region": np.arange(len(cells)) % 3})
    return p


def _vtu_base64(single_stream):
    def write(tmp):
        return _jtest("test_io")._vtu_appended_base64(tmp, single_stream)
    return write


def _vtu_compressed(tmp):
    """format="binary" + vtkZLibDataCompressor (tests/test_io.py)."""

    def inline(arr):
        raw = arr.tobytes()
        comp = zlib.compress(raw)
        head = np.asarray(
            [1, len(raw), len(raw), len(comp)], dtype=np.uint32
        ).tobytes()
        return (base64.b64encode(head) + base64.b64encode(comp)).decode()

    points = np.asarray(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype="<f8"
    )
    conn = np.asarray([0, 1, 2, 0, 2, 3], dtype="<i4")
    offs = np.asarray([3, 6], dtype="<i4")
    types = np.asarray([5, 5], dtype="<u1")
    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian" compressor="vtkZLibDataCompressor">
  <UnstructuredGrid>
    <Piece NumberOfPoints="4" NumberOfCells="2">
      <Points>
        <DataArray type="Float64" NumberOfComponents="3" format="binary">{inline(points)}</DataArray>
      </Points>
      <Cells>
        <DataArray type="Int32" Name="connectivity" format="binary">{inline(conn)}</DataArray>
        <DataArray type="Int32" Name="offsets" format="binary">{inline(offs)}</DataArray>
        <DataArray type="UInt8" Name="types" format="binary">{inline(types)}</DataArray>
      </Cells>
    </Piece>
  </UnstructuredGrid>
</VTKFile>
"""
    p = tmp / "inline_z.vtu"
    p.write_text(xml)
    return p


_PIECE = """    <Piece NumberOfPoints="3" NumberOfCells="1">
      <Points>
        <DataArray type="Float64" NumberOfComponents="3" format="ascii">
          {pts}
        </DataArray>
      </Points>
      <Cells>
        <DataArray type="Int32" Name="connectivity" format="ascii">0 1 2</DataArray>
        <DataArray type="Int32" Name="offsets" format="ascii">3</DataArray>
        <DataArray type="UInt8" Name="types" format="ascii">5</DataArray>
      </Cells>
      <PointData>
        <DataArray type="Float64" Name="f" format="ascii">{f}</DataArray>
      </PointData>
    </Piece>
"""


def _vtu_ascii(pieces):
    """ASCII pieces of tests/test_io.py's multi-piece file."""
    both = [_PIECE.format(pts="0 0 0  1 0 0  0 1 0", f="1 2 2"),
            _PIECE.format(pts="1 0 0  1 1 0  0 1 0", f="2 3 2")]

    def write(tmp):
        p = tmp / f"pieces{pieces}.vtu"
        p.write_text(
            '<?xml version="1.0"?>\n<VTKFile type="UnstructuredGrid" '
            'version="0.1" byte_order="LittleEndian">\n'
            "  <UnstructuredGrid>\n" + "".join(both[:pieces])
            + "  </UnstructuredGrid>\n</VTKFile>\n"
        )
        return p
    return write


def _vtk_legacy(kind):
    def write(tmp):
        m = _jtest("test_vtk_legacy")
        points, cells, poly = m._mesh()
        p = tmp / f"tri_{kind}.vtk"
        if kind == "binary":
            m._write_binary_vtk(p, points, cells, poly)
        else:
            m._write_ascii_vtk(p, points, cells, poly,
                               vtk9_layout=kind == "ascii-vtk9")
        return p
    return write


def _msh_text(const):
    def write(tmp):
        p = tmp / f"{const.lower()}.msh"
        p.write_text(getattr(_jtest("test_msh"), const))
        return p
    return write


def _msh_binary(version, endian):
    def write(tmp):
        m = _jtest("test_msh")
        p = tmp / f"bin{version}_{'le' if endian == '<' else 'be'}.msh"
        getattr(m, f"_write_msh{version}_binary")(p, endian)
        return p
    return write


def _text(module, const, name):
    def write(tmp):
        p = tmp / name
        p.write_text(getattr(_jtest(module), const))
        return p
    return write


def _tetgen(entry):
    def write(tmp):
        m = _jtest("test_simple_formats")
        (tmp / "tet.node").write_text(m.TETGEN_NODE)
        (tmp / "tet.ele").write_text(m.TETGEN_ELE)
        return tmp / entry
    return write


def _medit_sol(tmp):
    """A .mesh with its sibling .sol (tests/test_simple_formats.py)."""
    (tmp / "tet.mesh").write_text(_jtest("test_simple_formats").MEDIT_TET)
    (tmp / "tet.sol").write_text(
        "MeshVersionFormatted 2\nDimension 3\n"
        "SolAtVertices\n4\n2 1 2\n"
        "1.0  0 0 1\n2.0  0 0 2\n3.0  0 0 3\n4.0  0 0 4\n"
        "End\n"
    )
    return tmp / "tet.mesh"


def _medit_mixed(tmp):
    p = tmp / "mixed.mesh"
    p.write_text(
        "MeshVersionFormatted 2\nDimension 2\nVertices\n5\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n2 0 0\n"
        "Triangles\n1\n2 5 3 9\n"
        "Quadrilaterals\n1\n1 2 3 4 8\n"
        "End\n"
    )
    return p


def _ply_binary(endian, fmt):
    def write(tmp):
        header = (
            f"ply\nformat binary_{fmt}_endian 1.0\n"
            "element vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face 2\n"
            "property list uchar int vertex_indices\n"
            "end_header\n"
        ).encode()
        pts = np.array(
            [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=endian + "f4"
        )
        body = pts.tobytes()
        for face in ([0, 1, 2], [0, 2, 3]):
            body += struct.pack(endian + "B3i", 3, *face)
        p = tmp / f"square_{fmt}.ply"
        p.write_bytes(header + body)
        return p
    return write


def _stl_binary(tmp):
    tris = np.array(
        [
            [[0, 0, 0], [1, 0, 0], [1, 1, 0]],
            [[0, 0, 0], [1, 1, 0], [0, 1, 0]],
        ],
        dtype=np.float32,
    )
    rec = np.zeros(
        2,
        dtype=np.dtype(
            [("normal", "<f4", 3), ("verts", "<f4", (3, 3)), ("attr", "<u2")]
        ),
    )
    rec["verts"] = tris
    p = tmp / "square_bin.stl"
    p.write_bytes(b"\0" * 80 + struct.pack("<I", 2) + rec.tobytes())
    return p


def _abaqus_blank(tmp):
    """Blank fields and *NODE continuations (tests/test_fem_formats.py);
    every continuation line is followed by its data."""
    p = tmp / "c.inp"
    p.write_text(
        "*NODE\n"
        "1, 2.0, , 4.0\n"
        "2, 1.0,\n"
        " 2.0, 3.0\n"
        "*ELEMENT,\n"
        " TYPE=S3\n"
        "1, 1, 2, 1\n"
    )
    return p


def _avs_hex(tmp):
    """AVS-UCD hexahedron, top face first in the file."""
    p = tmp / "hex.avs"
    p.write_text(
        "8 1 0 0 0\n"
        + "".join(
            f"{i + 1} {x} {y} {z}\n"
            for i, (x, y, z) in enumerate(
                [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                 (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
            )
        )
        + "1 0 hex 5 6 7 8 1 2 3 4\n"
    )
    return p


def _ugrid_binary(suffix, endian, fdt):
    def write(tmp):
        tet_pts = _jtest("test_fem_formats").TET_PTS
        idt = np.dtype(endian + "i4")
        parts = [
            np.array([4, 4, 0, 1, 0, 0, 0], idt).tobytes(),
            tet_pts.astype(fdt).tobytes(),
            np.array(
                [[1, 2, 3], [1, 2, 4], [2, 3, 4], [1, 3, 4]], idt
            ).tobytes(),
            np.array([7, 7, 7, 7], idt).tobytes(),
            np.array([[1, 2, 3, 4]], idt).tobytes(),
        ]
        p = tmp / suffix
        p.write_bytes(b"".join(parts))
        return p
    return write


def _tecplot_varloc(tmp):
    text = _jtest("test_fem_formats").TECPLOT_BLOCK.replace(
        "VARLOCATION=([5]=CELLCENTERED)",
        "VARLOCATION=([1-4]=NODAL,[5]=CELLCENTERED)",
    )
    p = tmp / "varloc.tec"
    p.write_text(text)
    return p


def _gambit_hex(tmp):
    p = tmp / "hex.neu"
    p.write_text(
        "   NODAL COORDINATES 2.4.6\n"
        + "".join(
            f" {i + 1} {x} {y} {z}\n"
            for i, (x, y, z) in enumerate(
                [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                 (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
            )
        )
        + "ENDOFSECTION\n"
        "      ELEMENTS/CELLS 2.4.6\n"
        " 1 4 8 1 2 3 4 5 6 7 8\nENDOFSECTION\n"
    )
    return p


def _cross_format(name):
    """The 384-tet box of tests/test_fem_formats.py's cross-format test
    (its AVS-UCD file is left out: ROADMAP C3)."""

    def write(tmp):
        points, cells, _ = meshgen.tet_box_mesh(4, 4, 4)
        n, c = len(points), len(cells)
        if name == "m.su2":
            lines = ["NDIME= 3", f"NELEM= {c}"]
            lines += ["10 " + " ".join(map(str, row)) for row in cells]
            lines.append(f"NPOIN= {n}")
            lines += [f"{x} {y} {z} {i}" for i, (x, y, z) in enumerate(points)]
            lines.append("NMARK= 0")
        elif name == "m.ugrid":
            lines = [f"{n} 0 0 {c} 0 0 0"]
            lines += [f"{x} {y} {z}" for x, y, z in points]
            lines += [" ".join(str(v + 1) for v in row) for row in cells]
        elif name == "m.lb8.ugrid":
            idt, fdt = np.dtype("<i4"), np.dtype("<f8")
            (tmp / name).write_bytes(
                np.array([n, 0, 0, c, 0, 0, 0], idt).tobytes()
                + points.astype(fdt).tobytes()
                + (np.asarray(cells, idt) + 1).tobytes()
            )
            return tmp / name
        else:  # m.dat, Tecplot FEPOINT
            lines = ['VARIABLES = "X" "Y" "Z"',
                     f"ZONE N={n}, E={c}, F=FEPOINT, ET=TETRAHEDRON"]
            lines += [f"{x} {y} {z}" for x, y, z in points]
            lines += [" ".join(str(v + 1) for v in row) for row in cells]
        (tmp / name).write_text("\n".join(lines) + "\n")
        return tmp / name
    return write


def _xdmf(fmt_2d):
    def write(tmp):
        p = tmp / ("mesh2d.xdmf" if fmt_2d else "mesh.xdmf")
        _jtest("test_xdmf_exodus")._xdmf_inline(p, fmt_2d=fmt_2d)
        return p
    return write


def _xdmf_h5(tmp):
    h5py = pytest.importorskip("h5py")
    m = _jtest("test_xdmf_exodus")
    with h5py.File(tmp / "mesh.h5", "w") as f:
        f["/data/pts"] = m.TRI_PTS
        f["/data/conn"] = m.TRI_CELLS.astype(np.int32)
        f["/data/phi"] = m.TRI_PHI
    p = tmp / "mesh.xmf"
    p.write_text("""<?xml version="1.0"?>
<Xdmf Version="3.0">
 <Domain>
  <Grid Name="mesh">
   <Geometry GeometryType="XYZ">
    <DataItem DataType="Float" Dimensions="5 3" Format="HDF"
              Precision="8">mesh.h5:/data/pts</DataItem>
   </Geometry>
   <Topology TopologyType="Triangle" NumberOfElements="4">
    <DataItem DataType="Int" Dimensions="4 3" Format="HDF"
              Precision="4">mesh.h5:/data/conn</DataItem>
   </Topology>
   <Attribute Name="phi" AttributeType="Scalar" Center="Node">
    <DataItem DataType="Float" Dimensions="5" Format="HDF"
              Precision="8">mesh.h5:/data/phi</DataItem>
   </Attribute>
  </Grid>
 </Domain>
</Xdmf>
""")
    return p


def _exodus(tmp):
    p = tmp / "mesh.exo"
    _jtest("test_xdmf_exodus")._write_exodus(p)
    return p


def _cgns(tmp):
    p = tmp / "mesh.cgns"
    _jtest("test_xdmf_exodus")._write_cgns(p)
    return p


# AVS-UCD tetrahedra, ABAQUS rows ending in a dangling continuation and
# Nastran CHEXA20 / CPENTA15 cards are left out: ROADMAP C3 (see above)
READERS = {
    "vtu-raw": _vtu_raw,
    "vtu-base64-blocks": _vtu_base64(False),
    "vtu-base64-stream": _vtu_base64(True),
    "vtu-compressed": _vtu_compressed,
    "vtu-ascii": _vtu_ascii(1),
    "vtu-multi-piece": _vtu_ascii(2),
    "vtk-ascii": _vtk_legacy("ascii"),
    "vtk-ascii-vtk9": _vtk_legacy("ascii-vtk9"),
    "vtk-binary": _vtk_legacy("binary"),
    "msh-v2-ascii": _msh_text("MSH_V2"),
    "msh-v4-ascii": _msh_text("MSH_V4"),
    "msh-tet-ascii": _msh_text("MSH_TET"),
    "msh-v2-binary-le": _msh_binary(2, "<"),
    "msh-v2-binary-be": _msh_binary(2, ">"),
    "msh-v4-binary-le": _msh_binary(4, "<"),
    "msh-v4-binary-be": _msh_binary(4, ">"),
    "medit-tet": _text("test_simple_formats", "MEDIT_TET", "tet.mesh"),
    "medit-tri-2d": _text("test_simple_formats", "MEDIT_TRI_2D", "tri.mesh"),
    "medit-mixed-2d": _medit_mixed,
    "medit-sol": _medit_sol,
    "tetgen-node": _tetgen("tet.node"),
    "tetgen-ele": _tetgen("tet.ele"),
    "off": _text("test_simple_formats", "OFF_SQUARE", "square.off"),
    "off-uppercase": _text("test_simple_formats", "OFF_SQUARE", "SQUARE.OFF"),
    "ply-ascii": _text("test_simple_formats", "PLY_ASCII", "square.ply"),
    "ply-binary-le": _ply_binary("<", "little"),
    "ply-binary-be": _ply_binary(">", "big"),
    "stl-ascii": _text("test_simple_formats", "STL_ASCII", "square.stl"),
    "stl-binary": _stl_binary,
    "obj": _text("test_simple_formats", "OBJ_MIXED", "square.obj"),
    "abaqus": _text("test_fem_formats", "ABAQUS_TET", "tet.inp"),
    "abaqus-blank-fields": _abaqus_blank,
    "nastran-bdf": _text("test_fem_formats", "NASTRAN_TET", "tet.bdf"),
    "nastran-nas": _text("test_fem_formats", "NASTRAN_TET", "tet.nas"),
    "avs-hex": _avs_hex,
    "su2-tet": _text("test_fem_formats", "SU2_TET", "tet.su2"),
    "su2-tri-2d": _text("test_fem_formats", "SU2_TRI_2D", "tri.su2"),
    "flac3d": _text("test_fem_formats", "FLAC3D_TET", "tet.f3grid"),
    "ugrid-ascii": _text("test_fem_formats", "UGRID_TET", "tet.ugrid"),
    "ugrid-b8": _ugrid_binary("tet.b8.ugrid", ">", ">f8"),
    "ugrid-lb8": _ugrid_binary("tet.lb8.ugrid", "<", "<f8"),
    "ugrid-lb4": _ugrid_binary("tet.lb4.ugrid", "<", "<f4"),
    "tecplot-point": _text("test_fem_formats", "TECPLOT_POINT", "tet.dat"),
    "tecplot-block": _text("test_fem_formats", "TECPLOT_BLOCK", "tet.tec"),
    "tecplot-varlocation": _tecplot_varloc,
    "gambit-tet": _text("test_fem_formats", "GAMBIT_TET", "tet.neu"),
    "gambit-hex": _gambit_hex,
    "netgen": _text("test_fem_formats", "NETGEN_TET", "tet.vol"),
    "cross-su2": _cross_format("m.su2"),
    "cross-ugrid": _cross_format("m.ugrid"),
    "cross-ugrid-lb8": _cross_format("m.lb8.ugrid"),
    "cross-tecplot": _cross_format("m.dat"),
    "xdmf-xyz": _xdmf(False),
    "xdmf-xy": _xdmf(True),
    "xdmf-hdf5": _xdmf_h5,
    "exodus": _exodus,
    "cgns": _cgns,
}


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_same_mesh(jm, tm):
    _assert_same_array(jm.points, tm.points, "points")
    assert [cb.type for cb in jm.cells] == [cb.type for cb in tm.cells]
    for jb, tb in zip(jm.cells, tm.cells):
        _assert_same_array(jb.data, tb.data, f"cells {jb.type}")
    for fam in ("point_data", "cell_data"):
        jd, td = getattr(jm, fam), getattr(tm, fam)
        assert list(jd) == list(td), fam
        for name in jd:
            _assert_same_array(jd[name], td[name], f"{fam} {name}")


@pytest.mark.parametrize("case", list(READERS))
def test_read_mesh_matches_jax(tmp_path, case):
    _jax()
    from interpolate_unstructured_tpu.io.convert import read_mesh

    path = READERS[case](tmp_path)
    jm = read_mesh(path)
    tm = tconvert.read_mesh(path)
    assert len(tm.points) > 0 and tm.cells
    _assert_same_mesh(jm, tm)


# ---------------------------------------------------------------------------
# binda
# ---------------------------------------------------------------------------


def _binda_entries(rng):
    return [
        ("points", rng.random((7, 3)), ""),
        ("cells", rng.integers(0, 7, (5, 4)).astype(np.int64), "tetra"),
        ("f32", rng.random(6).astype(np.float32), "float32"),
        ("i32", np.arange(-3, 3, dtype=np.int32), "int32"),
        ("flag", (rng.random(4) > 0.5).astype(np.int32), "bool"),
        ("scalar", np.float64(2.5), ""),
        ("empty", np.zeros((0, 3)), "nothing"),
        ("point_data", rng.random(7), "a name, with spaces"),
    ]


def test_binda_bytes_and_cross_reads_match_jax(tmp_path):
    _jax()
    from interpolate_unstructured_tpu.io import binda as jbinda

    files = {}
    for tag, mod in (("jax", jbinda), ("port", tbinda)):
        w = mod.BindaWriter()
        for name, data, meta in _binda_entries(np.random.default_rng(1)):
            w.add_entry(name, data, meta)
        files[tag] = tmp_path / f"{tag}.binda"
        w.write_to_file(files[tag])
    assert filecmp.cmp(files["jax"], files["port"], shallow=False)
    for reader, path in ((tbinda.read_binda, files["jax"]),
                         (jbinda.read_binda, files["port"])):
        ref = jbinda.read_binda(files["jax"])
        bf = reader(path)
        assert [dataclasses.astuple(e) for e in bf.entries] == [
            dataclasses.astuple(e) for e in ref.entries]
        for i in range(len(ref.entries)):
            _assert_same_array(bf.read(i), ref.read(i), ref.entries[i].name)
        assert bf.index("point_data") == ref.index("point_data")
        assert bf.indices("cells") == ref.indices("cells")
        _assert_same_array(bf.read_float64(0), ref.read_float64(0), "f64")
        _assert_same_array(bf.read_int32(1), ref.read_int32(1), "i32")


def _bad_binda(tmp, kind):
    """A file or an entry that both packages must reject."""
    good = tmp / "good.binda"
    w = tbinda.BindaWriter()
    w.add_entry("x", np.arange(4.0))
    w.write_to_file(good)
    raw = bytearray(good.read_bytes())
    p = tmp / f"{kind}.binda"
    if kind == "magic":
        raw[:5] = b"NOPE "
    elif kind == "header-size":
        raw[16:24] = struct.pack("<q", 999)
    elif kind == "dtype":
        raw[24 + 128 : 24 + 256] = b"int16".ljust(128)
    p.write_bytes(bytes(raw))
    return p


@pytest.mark.parametrize("kind", [
    "int32-overflow", "int32-underflow", "long-name", "long-metadata",
    "ndim", "magic", "header-size", "dtype", "not-float", "not-int",
])
def test_binda_rejects_like_jax(tmp_path, kind):
    """The port rejects what the JAX package rejects, with the same
    exception and message (the int32 range check included)."""
    _jax()
    from interpolate_unstructured_tpu.io import binda as jbinda

    def attempt(mod):
        if kind in ("int32-overflow", "int32-underflow", "long-name",
                    "long-metadata", "ndim"):
            data = {
                "int32-overflow": np.asarray([2**31], dtype=np.int64),
                "int32-underflow": np.asarray([-(2**31) - 1], dtype=np.int64),
                "ndim": np.zeros((1,) * 9),
            }.get(kind, np.zeros(2))
            name = "n" * 129 if kind == "long-name" else "x"
            meta = "m" * 129 if kind == "long-metadata" else ""
            mod.BindaWriter().add_entry(name, data, meta)
        elif kind in ("not-float", "not-int"):
            w = mod.BindaWriter()
            w.add_entry("f", np.arange(3.0))
            w.add_entry("i", np.arange(3))
            w.write_to_file(tmp_path / "fi.binda")
            bf = mod.read_binda(tmp_path / "fi.binda")
            if kind == "not-float":
                bf.read_float64(1)
            else:
                bf.read_int32(0)
        else:
            bf = mod.read_binda(_bad_binda(tmp_path, kind))
            bf.read(0)

    errors = []
    for mod in (jbinda, tbinda):
        with pytest.raises((ValueError, TypeError)) as ei:
            attempt(mod)
        errors.append((type(ei.value), str(ei.value)))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# Converter and command-line entry points
# ---------------------------------------------------------------------------


def _write_box_vtu(path, n=3):
    pts, cells, _ = meshgen.tet_box_mesh(n, n, n)
    from interpolate_unstructured_tpu_torch.io.vtk import write_vtu

    write_vtu(path, pts, cells, "tetra", point_data=_point_data(pts),
              cell_data={"vol, m3": np.linspace(0.5, 1.5, len(cells))},
              icell_data={"region": np.arange(len(cells)) % 3})


@pytest.mark.parametrize("case", ["vtu-raw", "vtk-ascii", "msh-tet-ascii",
                                  "tetgen-node", "su2-tri-2d", "exodus"])
def test_convert_to_binda_matches_jax(tmp_path, case, capsys):
    """The same input converts to the same bytes, and the cache behaves
    alike: skip while the .binda is newer, rewrite with force, pass a
    .binda through."""
    _jax()
    from interpolate_unstructured_tpu.io import convert as jconvert

    src = READERS[case](tmp_path)
    outs = {}
    for tag, mod in (("jax", jconvert), ("port", tconvert)):
        base = str(tmp_path / f"out_{tag}")
        out = mod.convert_to_binda(src, base, verbose=True)
        assert out == base + ".binda"
        stamp = os.path.getmtime(out)
        os.utime(out, (stamp + 10, stamp + 10))
        assert mod.convert_to_binda(src, base, verbose=True) == out
        assert os.path.getmtime(out) == stamp + 10  # cached, not rewritten
        mod.convert_to_binda(src, base, force=True)
        assert os.path.getmtime(out) != stamp + 10
        assert mod.convert_to_binda(out) == out
        outs[tag] = out
    assert filecmp.cmp(outs["jax"], outs["port"], shallow=False)
    printed = capsys.readouterr().out.replace("out_jax", "out_X").replace(
        "out_port", "out_X").splitlines()
    assert printed[:2] == printed[2:4] and "up to date" in printed[1]


def test_mesh_to_binda_writer_rejects_like_jax():
    _jax()
    from interpolate_unstructured_tpu.io import convert as jconvert
    from interpolate_unstructured_tpu.io import vtu as jvtu
    from interpolate_unstructured_tpu_torch.io import vtu as tvtu

    for kind in ("mixed", "hexahedron"):
        errors = []
        for conv, vtu in ((jconvert, jvtu), (tconvert, tvtu)):
            if kind == "mixed":
                cells = [vtu.CellBlock("triangle", np.array([[0, 1, 2]])),
                         vtu.CellBlock("quad", np.array([[0, 1, 2, 3]]))]
            else:
                cells = [vtu.CellBlock("hexahedron", np.arange(8)[None])]
            mesh = vtu.Mesh(points=np.zeros((8, 3)), cells=cells)
            with pytest.raises(ValueError) as ei:
                conv.mesh_to_binda_writer(mesh)
            errors.append(str(ei.value))
        assert errors[0] == errors[1]


def test_command_line_entry_points_match_jax(tmp_path):
    """``python -m ...io.convert <mesh>`` and ``python -m ...io.binda
    <file>`` of both packages: the same .binda bytes and the same
    printout.  The port's processes run with a ``jax`` that fails to
    import, so neither can import jax or the JAX package."""
    _jax()
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text(
        "raise ImportError('jax imported by the port')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = {}
    for tag, pkg, path in (
        ("jax", "interpolate_unstructured_tpu", REPO),
        ("port", "interpolate_unstructured_tpu_torch",
         os.pathsep.join([str(stub), REPO])),
    ):
        d = tmp_path / tag
        d.mkdir()
        _write_box_vtu(d / "box.vtu")
        run_env = dict(env, PYTHONPATH=path, JAX_PLATFORMS="cpu")
        out = []
        for args in ([f"{pkg}.io.convert", "box.vtu"],
                     [f"{pkg}.io.binda", "box.binda"]):
            p = subprocess.run([sys.executable, "-m", *args], cwd=d,
                               env=run_env, capture_output=True, text=True,
                               timeout=300)
            assert p.returncode == 0, p.stderr
            out.append(p.stdout)
        runs[tag] = out
    assert runs["jax"] == runs["port"]
    assert runs["port"][0] == "Stored box.binda\n"
    assert "cell_neighbors" in runs["port"][1]
    assert filecmp.cmp(tmp_path / "jax" / "box.binda",
                       tmp_path / "port" / "box.binda", shallow=False)


# ---------------------------------------------------------------------------
# read_grid, write_vtk, write_trace_vtk, validate_grid
# ---------------------------------------------------------------------------

GRIDS = {
    "triangle": ("triangle", lambda: meshgen.triangle_rect_mesh(4, 4),
                 "auto", HOST),
    "quad": ("quad", lambda: meshgen.quad_rect_mesh(8, 8), "auto", HOST),
    "tetra": ("tetra", lambda: meshgen.tet_box_mesh(5, 5, 5), "auto", HOST),
    "tetra-candidates": (
        "tetra", lambda: meshgen.tet_box_mesh(12, 12, 12), "walk",
        dataclasses.replace(HOST, cand_bins_per_cell=0.3,
                            cand_ext_max_k=256, cand_cover_row_bytes=0),
    ),
}
HOST_LEAVES = ("points", "cells", "neighbors", "cell_points", "face_normals",
               "face_offsets", "cell_volume", "point_is_at_boundary",
               "point_data", "cell_data", "icell_data", "rmin", "rmax")


def _write_grid_vtu(tmp, case):
    cell_type, mesh, _, _ = GRIDS[case]
    pts, cells, _ = mesh()
    p = tmp / f"{case}.vtu"
    from interpolate_unstructured_tpu_torch.io.vtk import write_vtu

    write_vtu(p, pts, cells, cell_type, point_data=_point_data(pts),
              cell_data={"c": np.arange(len(cells)) * 0.5},
              icell_data={"id": np.arange(len(cells)) % 7})
    return p, pts


def _queries(pts, n=3000, seed=3):
    rng = np.random.default_rng(seed)
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    r = lo - 0.1 * span + rng.random((n, 3)) * 1.2 * span
    if span[2] == 0:
        r[:, 2] = 0.0
    return r.astype(np.float32)


@pytest.mark.parametrize("case", list(GRIDS))
def test_read_grid_matches_jax(tmp_path, case):
    jnp, jiu = _jax()
    _, _, mode, cfg = GRIDS[case]
    path, pts = _write_grid_vtu(tmp_path, case)
    ug = jiu.read_grid(path, dtype=jnp.float32, locate_mode=mode,
                       config=jiu.IUConfig(**dataclasses.asdict(cfg)))
    tg = tiu.read_grid(path, dtype=torch.float32, locate_mode=mode,
                       config=cfg, device="cpu")
    assert tg.device.type == "cpu" and tg.locate_mode == ug.locate_mode
    for f in HOST_LEAVES:
        _assert_same_array(getattr(tg, f).numpy(), getattr(ug, f), f)
    for f in ("point_data_names", "cell_data_names", "icell_data_names",
              "cell_type", "bin_shape", "cand_shape"):
        assert getattr(tg, f) == getattr(ug, f), f
    if case == "tetra-candidates":
        assert tg.cand_ext_table is not None
        for f in ("cand_ids", "cand_count", "cand_ext_ids", "cand_ext_slot"):
            _assert_same_array(getattr(tg, f).numpy(), getattr(ug, f), f)
    r = _queries(pts)
    jv, jic, jf = jiu.interpolate_scalar_at(ug, jnp.asarray(r), 0)
    tv, tic, tf = tiu.interpolate_scalar_at(tg, torch.from_numpy(r), 0)
    jf = np.asarray(jf)
    assert 0 < jf.sum() < len(r)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tic.numpy(), np.asarray(jic))
    np.testing.assert_allclose(tv.numpy()[jf], np.asarray(jv)[jf], rtol=0,
                               atol=2e-6)


def test_read_grid_binda_and_device_default(tmp_path):
    """A .binda path is read as it is; without ``device=`` a process
    with no CUDA device gets an error, not a grid on the host."""
    path, pts = _write_grid_vtu(tmp_path, "triangle")
    binda = tconvert.convert_to_binda(path)
    g = tiu.read_grid(binda, device="cpu", coord_scale_factor=2.0)
    assert float(g.rmax[0]) == 2.0 * pts[:, 0].max()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tiu.read_grid(binda)


def _carry(ug):
    """A JAX grid's state carried into the port, bits unchanged."""
    from interpolate_unstructured_tpu_torch.models.grid import (
        DATA_FIELDS,
        META_FIELDS,
    )

    leaves = {
        f: None if getattr(ug, f) is None else np.asarray(getattr(ug, f))
        for f in DATA_FIELDS
    }
    return tiu.grid_from_numpy(
        leaves, {f: getattr(ug, f) for f in META_FIELDS}, "cpu"
    )


@pytest.mark.parametrize("case", ["triangle", "quad", "tetra"])
def test_write_vtk_bytes_match_jax(tmp_path, case):
    jnp, jiu = _jax()
    path, _ = _write_grid_vtu(tmp_path, case)
    ug = jiu.read_grid(path, dtype=jnp.float32)
    jiu.write_vtk(ug, tmp_path / "jax.vtu")
    tiu.write_vtk(_carry(ug), tmp_path / "port.vtu")
    assert filecmp.cmp(tmp_path / "jax.vtu", tmp_path / "port.vtu",
                       shallow=False)
    # and the written file reads back to the grid's mesh
    m = tconvert.read_mesh(tmp_path / "port.vtu")
    np.testing.assert_array_equal(m.cells[0].data, np.asarray(ug.cells))


@pytest.mark.parametrize("min_points", [1, 2])
def test_write_trace_vtk_bytes_match_jax(tmp_path, min_points):
    jnp, jiu = _jax()
    pts, cells, nbrs = meshgen.triangle_rect_mesh(6, 6)
    pd = {"vx": -(pts[:, 1] - 0.5), "vy": pts[:, 0] - 0.5}
    ug = jiu.build_grid(pts, cells, nbrs, "triangle", point_data=pd,
                        dtype=jnp.float64)
    y0 = jnp.asarray([[0.7, 0.5, 0.0], [0.6, 0.5, 0.0], [5.0, 5.0, 0.0]],
                     jnp.float64)
    res = jiu.integrate_along_field(
        ug, y0, (0, 1), nvar=1, sub_int=lambda f, y: jnp.ones(1),
        min_dx=1e-4, max_dx=0.05, max_steps=24, rtol=1e-3, atol=1e-3,
    )
    port_res = tiu.TraceResult(*(
        None if v is None else torch.from_numpy(np.array(v)) for v in res
    ))
    jiu.write_trace_vtk(res, tmp_path / "jax.vtu", min_points=min_points)
    tiu.write_trace_vtk(port_res, tmp_path / "port.vtu",
                        min_points=min_points)
    assert filecmp.cmp(tmp_path / "jax.vtu", tmp_path / "port.vtu",
                       shallow=False)


def _broken(g, kind):
    """A deliberately broken copy of a port grid."""
    if kind == "good":
        return g
    if kind == "asymmetric":
        nb = g.neighbors.clone()
        nb[0, 0] = 5
        return dataclasses.replace(g, neighbors=nb)
    if kind == "neighbor-range":
        nb = g.neighbors.clone()
        nb[0, 0] = g.n_cells + 5
        return dataclasses.replace(g, neighbors=nb)
    if kind == "cell-range":
        cells = g.cells.clone()
        cells[0, 0] = g.n_points + 3
        return dataclasses.replace(g, cells=cells)
    if kind == "normals":
        return dataclasses.replace(g, face_normals=-1.5 * g.face_normals)
    if kind == "volume":
        vol = g.cell_volume.clone()
        vol[:3] = -1.0
        return dataclasses.replace(g, cell_volume=vol)
    if kind == "cell-points":
        cp = g.cell_points.clone()
        cp[1, 0, 0] += 0.25
        return dataclasses.replace(g, cell_points=cp)
    if kind == "seed-table":
        bt = g.bin_table.clone()
        bt[0] = -2
        return dataclasses.replace(g, bin_table=bt)
    if kind == "registry":
        return dataclasses.replace(g, point_data_names=("a", "b", "c"))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", [
    "good", "asymmetric", "neighbor-range", "cell-range", "normals",
    "volume", "cell-points", "seed-table", "registry",
])
def test_validate_grid_matches_jax(tmp_path, kind):
    """The same report on a healthy grid and on deliberately broken
    copies; ``strict`` raises with the same message."""
    _, jiu = _jax()
    from interpolate_unstructured_tpu.utils.validate import (
        validate_grid as jvalidate,
    )

    path, _ = _write_grid_vtu(tmp_path, "tetra")
    ug = jiu.read_grid(path)
    tg = _broken(_carry(ug), kind)
    jbad = _carry_back(tg, ug)
    jp = jvalidate(jbad, strict=False)
    tp = tiu.validate_grid(tg, strict=False)
    assert tp == jp
    assert (tp == []) == (kind == "good")
    if tp:
        msgs = []
        for fn, g in ((jvalidate, jbad), (tiu.validate_grid, tg)):
            with pytest.raises(ValueError) as ei:
                fn(g)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def _carry_back(tg, ug):
    """The port grid's tensors put back into the JAX grid's dataclass."""
    import jax.numpy as jnp

    fields = ("neighbors", "cells", "face_normals", "cell_volume",
              "cell_points", "bin_table")
    kw = {f: jnp.asarray(getattr(tg, f).numpy()) for f in fields}
    return dataclasses.replace(ug, point_data_names=tg.point_data_names,
                               **kw)
