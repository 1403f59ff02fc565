"""Multi-chip scaling: rays/tiles sharded over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2.5 "Parallelism"); this
subsystem is new design per SURVEY.md §7.1 step 6:

* one mesh axis ("rays") shards the pixel/ray wavefront;
* the scene (BVH, triangles, materials, textures, env CDFs) is
  *replicated* into every device's memory — path tracing reads it
  randomly, so replication beats gathers across devices;
* forward rendering needs **zero** collectives (pixel-disjoint work);
* the differentiable path all-reduces parameter gradients with `psum`
  across devices inside the same jitted step, so XLA overlaps the collective
  with the backward sweep;
* multi-host: initialize `jax.distributed`, build the mesh over all
  devices; data loading happens host-side and is broadcast by GSPMD.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from cadrays_tpu.core.camera import Camera
from cadrays_tpu.integrator.params import RenderParams
from cadrays_tpu.integrator.wavefront import render_sample
from cadrays_tpu.scene.flatten import SceneData

RAY_AXIS = "rays"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (RAY_AXIS,))


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def render_tiled_sharded(scene: SceneData, camera: Camera,
                         params: RenderParams, width: int, height: int,
                         spp: int, mesh: Mesh):
    """Render with the pixel axis sharded over `mesh`; returns (H, W, 3).

    Implemented with shard_map so the per-device body is exactly the
    single-chip wavefront integrator on its pixel slice — no collectives
    in the forward pass.
    """
    n = mesh.devices.size
    total = width * height
    padded = _pad_to(total, n)
    pixel_ids = jnp.arange(padded, dtype=jnp.int32) % total

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(), P(RAY_AXIS)),
             out_specs=P(RAY_AXIS), check_vma=False)
    def shard_body(scene_, camera_, pids):
        def body(acc, i):
            s = render_sample(scene_, camera_, params, width, height,
                              i, pixel_ids=pids)
            return acc + s, None

        acc0 = jnp.zeros((pids.shape[0], 3), jnp.float32)
        acc, _ = jax.lax.scan(body, acc0,
                              jnp.arange(spp, dtype=jnp.uint32), length=spp)
        return acc / spp

    flat = shard_body(scene, camera, pixel_ids)
    return flat[:total].reshape(height, width, 3)


@partial(jax.jit, static_argnames=("width", "height", "spp", "mesh"))
def render_sharded_jit(scene: SceneData, camera: Camera, params: RenderParams,
                       width: int, height: int, spp: int, mesh: Mesh):
    return render_tiled_sharded(scene, camera, params, width, height, spp,
                                mesh)


def render_persistent_sharded(scene: SceneData, camera: Camera,
                              params: RenderParams, width: int, height: int,
                              spp: int, n_steps: int, mesh: Mesh):
    """The production GI path (persistent wavefront) over the mesh.

    Ray-axis sharded via shard_map: each device runs the full
    regenerating scan — including the per-bounce coherence sort — on its
    LOCAL lane slice (a global sort would cost an all-to-all per bounce
    for zero estimator benefit; lane order is pure optimization).
    Forward needs no collectives; under `jax.grad` the replicated scene
    (in_spec P()) makes shard_map's transpose psum parameter gradients
    across devices automatically.

    Returns (sum_img (padded, 3), cnt (padded,)) in pixel order —
    callers slice [:width*height] and divide; per-lane radiance is
    bitwise independent of the device count (RNG is keyed on pixel id,
    not lane position), so sharded == single-device up to float
    reduction order inside a lane (i.e. exactly).
    """
    n = mesh.devices.size
    total = width * height
    padded = _pad_to(total, n)
    pixel_ids = jnp.arange(padded, dtype=jnp.int32) % total

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(), P(RAY_AXIS)),
             out_specs=(P(RAY_AXIS), P(RAY_AXIS)), check_vma=False)
    def shard_body(scene_, camera_, pids):
        from cadrays_tpu.integrator.persistent import render_persistent

        return render_persistent(scene_, camera_, params, width, height,
                                 spp, n_steps, pixel_ids=pids)

    return shard_body(scene, camera, pixel_ids)


@partial(jax.jit,
         static_argnames=("width", "height", "spp", "n_steps", "mesh"))
def render_persistent_sharded_jit(scene: SceneData, camera: Camera,
                                  params: RenderParams, width: int,
                                  height: int, spp: int, n_steps: int,
                                  mesh: Mesh):
    return render_persistent_sharded(scene, camera, params, width, height,
                                     spp, n_steps, mesh)


def scene_replicated(scene: SceneData, mesh: Mesh) -> SceneData:
    """Place every scene leaf replicated on the mesh (one copy per device)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(scene, sharding)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up over DCN (jax.distributed). No-op if
    single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
