"""Modeling kernel: the DRAW solid-modeling command surface, mesh-backed.

The reference delegates modeling to OCCT's BRep kernel and exposes it
through DRAW Tcl commands (`circle`, `wire`, `mkplane`, `prism`,
`blend`, `bcut`, ... — exercised by data/scripts/Bottle.tcl, Cpu.tcl,
Cutter.tcl, Drill.tcl, Shape.tcl). This package re-implements that
capability surface natively with a deliberately different architecture:

* analytic 2D/3D curves + parametric surfaces (curves.py, surfaces.py)
  keep exact parameterization for `trim`/`cvalue`/`parameters`;
* topology (topo.py) is light: faces are planar regions (frame + 2D
  loops), solids are watertight triangle meshes with per-triangle face
  ids — the render path consumes triangles anyway, so the mesh IS
  the boundary representation;
* booleans (csg.py + native/mesh_csg.cpp) run on a C++ BSP core; 2D
  face booleans reuse it by thin extrusion + cross-section, so there is
  exactly one robustness-critical algorithm in the stack;
* generative ops (ops.py): prism, revol, loft (`thrusections`), the
  guided-sweep pipeline (`mksweep`/`setsweep`/`addsweep`/`buildsweep`),
  offsets and fillets.
"""
