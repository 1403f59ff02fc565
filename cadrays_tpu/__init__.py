"""cadrays_tpu — a differentiable progressive path tracer in JAX.

A from-scratch JAX/XLA framework with the capability surface of
CADRays (a GPU path tracer for CAD models): progressive unbiased path
tracing with a double-layered BSDF, next-event estimation against
directional / positional / environment lights, thin-lens and orthographic
cameras, adaptive tile sampling, filmic tone mapping, a named scene graph
with a scriptable command surface, mesh/CAD import and scene export —
redesigned around array programs:

* the integrator is a megakernel-free **wavefront** loop (`lax.scan` over
  bounces, statically shaped masked ray batches) instead of a GLSL
  megakernel;
* ray/BVH traversal runs over a **threaded (stackless skip-link) BVH**
  laid out as flat SoA arrays; on an NVIDIA GPU a CUDA kernel walks it
  one thread per ray (ops/traverse_cuda.py);
* everything is differentiable: pixel gradients flow to material, light
  and camera parameters via detached-sampling custom VJPs;
* scaling is `jax.sharding` / `shard_map` over a device mesh (rays/tiles
  sharded, scene replicated in device memory, gradient `psum` across
  devices) — not a single-GPU GL context.

Reference capability surface: sasobadovinac/CADRays (see SURVEY.md).
"""

from cadrays_tpu.version import __version__

# Core value types
from cadrays_tpu.core.camera import Camera
from cadrays_tpu.core.bsdf import Material, material
from cadrays_tpu.core.fresnel import (
    FRESNEL_CONSTANT,
    FRESNEL_SCHLICK,
    FRESNEL_CONDUCTOR,
    FRESNEL_DIELECTRIC,
    fresnel,
)
from cadrays_tpu.core.lights import Lights, directional_light, positional_light
from cadrays_tpu.core.tonemap import ToneMapParams

# Scene layer
from cadrays_tpu.scene.model import DataNode, DataModel, NodeType
from cadrays_tpu.scene.scene import Scene
from cadrays_tpu.scene.flatten import SceneData

# Rendering layer
from cadrays_tpu.integrator.params import RenderParams, RenderMode
from cadrays_tpu.integrator.renderer import Renderer
from cadrays_tpu.integrator.progressive import ProgressiveState

# Geometry
from cadrays_tpu.geometry.mesh import TriangleMesh
from cadrays_tpu.geometry import primitives

__all__ = [
    "__version__",
    "Camera",
    "Material",
    "material",
    "FRESNEL_CONSTANT",
    "FRESNEL_SCHLICK",
    "FRESNEL_CONDUCTOR",
    "FRESNEL_DIELECTRIC",
    "fresnel",
    "Lights",
    "directional_light",
    "positional_light",
    "ToneMapParams",
    "DataNode",
    "DataModel",
    "NodeType",
    "Scene",
    "SceneData",
    "RenderParams",
    "RenderMode",
    "Renderer",
    "ProgressiveState",
    "TriangleMesh",
    "primitives",
]
