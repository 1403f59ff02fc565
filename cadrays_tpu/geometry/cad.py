"""CAD import: STEP / IGES / BREP via pluggable tessellation backends.

Capability contract: the reference imports STEP/IGES through OCCT's DRAW
commands (`testreadstep`/`testreadiges`, ImportSettingsEditor.cxx:317-370)
and BREP via `restore` (:290-316); the *engine* only ever consumes the
tessellated triangles (SURVEY.md §7.1 step 2: "OCCT-as-a-tool is
acceptable for tessellation only"). This module mirrors that split: a CAD
file goes through a registered tessellator that returns `TriangleMesh`
parts (+ per-face UVs when available); the framework itself never links a
CAD kernel.

Backends probed in order:
  * pythonocc / OCP (`OCC.Core` or `OCP`) when installed;
  * `cadquery` when installed;
  * a user-registered callable via `register_tessellator`.

When none is installed, `load_cad` raises a
precise, actionable error (listing the formats that *are* native:
OBJ/PLY/STL/glTF) rather than failing deep in the pipeline.
"""
from __future__ import annotations

import warnings
from typing import Callable, List, Optional

from cadrays_tpu.geometry.mesh import TriangleMesh

CAD_EXTENSIONS = (".step", ".stp", ".iges", ".igs", ".brep")

_TESSELLATOR: Optional[Callable[[str, float], List[TriangleMesh]]] = None


def register_tessellator(fn: Callable[[str, float], List[TriangleMesh]]) -> None:
    """Install a custom CAD tessellator: fn(path, deflection) -> meshes."""
    global _TESSELLATOR
    _TESSELLATOR = fn


def _try_occ_backend():
    try:  # pythonocc-core
        from OCC.Core.BRepMesh import BRepMesh_IncrementalMesh  # noqa: F401

        return _occ_tessellate
    except ImportError:
        pass
    try:  # OCP (cadquery's binding)
        import OCP  # noqa: F401

        return _ocp_tessellate
    except ImportError:
        pass
    return None


def _occ_tessellate(path: str, deflection: float) -> List[TriangleMesh]:
    """pythonocc tessellation (runs only when OCC.Core is installed)."""
    import numpy as np
    from OCC.Core.BRep import BRep_Tool
    from OCC.Core.BRepMesh import BRepMesh_IncrementalMesh
    from OCC.Core.IGESControl import IGESControl_Reader
    from OCC.Core.STEPControl import STEPControl_Reader
    from OCC.Core.TopAbs import TopAbs_FACE
    from OCC.Core.TopExp import TopExp_Explorer
    from OCC.Core.TopLoc import TopLoc_Location
    from OCC.Core.TopoDS import topods

    low = path.lower()
    if low.endswith((".step", ".stp")):
        reader = STEPControl_Reader()
    else:
        reader = IGESControl_Reader()
    reader.ReadFile(path)
    reader.TransferRoots()
    shape = reader.OneShape()
    BRepMesh_IncrementalMesh(shape, deflection)

    meshes = []
    exp = TopExp_Explorer(shape, TopAbs_FACE)
    while exp.More():
        face = topods.Face(exp.Current())
        loc = TopLoc_Location()
        tri = BRep_Tool.Triangulation(face, loc)
        if tri is not None:
            n = tri.NbNodes()
            verts = np.array([[tri.Node(i + 1).X(), tri.Node(i + 1).Y(),
                               tri.Node(i + 1).Z()] for i in range(n)],
                             np.float32)
            tfm = loc.Transformation()
            m = np.eye(4, dtype=np.float32)
            for r in range(3):
                for c in range(4):
                    m[r, c] = tfm.Value(r + 1, c + 1)
            idx = np.array([tri.Triangle(i + 1).Get()
                            for i in range(tri.NbTriangles())],
                           np.int32) - 1
            mesh = TriangleMesh(verts, idx).transformed(m)
            mesh.compute_vertex_normals()
            meshes.append(mesh)
        exp.Next()
    return meshes


def _ocp_tessellate(path: str, deflection: float) -> List[TriangleMesh]:
    raise NotImplementedError(
        "OCP backend detected but the adapter is not implemented; "
        "register a tessellator via register_tessellator()")


def load_cad(path: str, deflection: float = 0.0) -> List[TriangleMesh]:
    """Tessellate a STEP/IGES/BREP file into triangle meshes.

    deflection: linear tessellation tolerance (the reference exposes the
    same knob as `incmesh <shape> <deflection>`, preview.tcl:24);
    <= 0 auto-picks from the model extent.

    STEP and IGES are read by the framework's own B-rep pipeline
    (`geometry/step.py` / `geometry/iges.py` over `tessellate.py`); a
    user-registered or pythonocc backend, when present, takes priority
    (useful for exotic entity mixes the native reader doesn't cover)."""
    backend = _TESSELLATOR or _try_occ_backend()
    backend_err: Optional[Exception] = None
    if backend is not None:
        try:
            return backend(path, deflection if deflection > 0 else 0.01)
        except Exception as exc:  # fall through to the native readers
            backend_err = exc
            warnings.warn(
                f"registered CAD backend failed on {path!r}: {exc!r}; "
                "falling back to the native reader", stacklevel=2)
    low = path.lower()
    if low.endswith((".step", ".stp")):
        from cadrays_tpu.geometry.step import load_step

        return load_step(path, deflection)
    if low.endswith((".iges", ".igs")):
        from cadrays_tpu.geometry.iges import load_iges

        return load_iges(path, deflection)
    if low.endswith(".brep"):
        from cadrays_tpu.geometry.brep import load_brep

        return load_brep(path, deflection)
    if backend_err is not None:
        raise RuntimeError(
            f"CAD backend failed on {path!r}: {backend_err}") from backend_err
    raise RuntimeError(
        f"no CAD tessellation backend available for {path!r}. "
        "STEP/IGES/BREP are native; other CAD kernels can be plugged via "
        "cadrays_tpu.geometry.cad.register_tessellator; "
        "OBJ/PLY/STL/glTF import is native (rtmeshread).")
