"""Progressive accumulation with restart-on-change.

Contract: the reference accumulates one sample pass per Redraw into
ping-pong FBOs and restarts accumulation whenever the camera world-view
state changes (AppViewer.cxx:979-984, 1045-1047; AppGui.cxx:122-136
`myAccumFrames`). Here the accumulator is a plain sharded
array in a pytree; "restart" is comparing a fingerprint of the
scene/camera/params snapshot and zeroing the state. The state is also the
resumable render checkpoint (SURVEY.md §5 checkpoint/resume) — serialize
it with save_state/load_state and continue adding samples later.

When params.adaptive is on (`vrenderparams -iss`), each step spends its
W*H-sample budget through the variance-guided tile allocator
(integrator/adaptive.py) instead of uniformly; the per-pixel weight
buffer tracks the non-uniform sample counts.
"""
from __future__ import annotations

import hashlib
from typing import Optional

from cadrays_tpu.utils import struct
import jax
import jax.numpy as jnp
import numpy as np

from cadrays_tpu.core.camera import Camera
from cadrays_tpu.integrator.params import RenderMode, RenderParams
from cadrays_tpu.integrator.renderer import render_image
from cadrays_tpu.scene.flatten import SceneData


@struct.dataclass
class ProgressiveState:
    accum: jnp.ndarray  # (H, W, 3) running radiance *sum*
    weight: jnp.ndarray  # (H, W) per-pixel sample counts
    accum_sq: jnp.ndarray  # (H, W) luminance^2 sum (adaptive variance)
    spp: jnp.ndarray  # scalar int32 — accumulated passes (budget units)
    fingerprint: str = struct.field(pytree_node=False, default="")

    @property
    def image(self) -> jnp.ndarray:
        """Current HDR estimate."""
        return self.accum / jnp.maximum(self.weight[..., None], 1.0)


def state_fingerprint(scene: SceneData, camera: Camera,
                      params: RenderParams, width: int, height: int) -> str:
    """Cheap hash of everything that invalidates accumulation.

    Camera and params are hashed in full (they're tiny). The scene keys on
    its mutation counter (`SceneData.version`, stamped by Scene.flatten on
    every edit) plus array shapes; strided content sampling is NOT used —
    it can miss edits landing between strides. Unstamped snapshots
    (version < 0, e.g. hand-built SceneData) fall back to a full content
    hash, which is exact but costs a device->host pull per frame.
    """
    h = hashlib.sha1()
    h.update(f"{width}x{height}|{params.mode}|{params.ray_depth}|"
             f"{params.adaptive}".encode())
    for leaf in jax.tree.leaves((camera, params)):
        h.update(np.asarray(leaf).tobytes())
    h.update(f"v{scene.version}".encode())
    for leaf in jax.tree.leaves(scene):
        a = np.asarray(leaf)
        h.update(str(a.shape).encode())
        if scene.version < 0:
            h.update(a.tobytes())
    return h.hexdigest()


def init_state(width: int, height: int, fingerprint: str = "") -> ProgressiveState:
    return ProgressiveState(
        accum=jnp.zeros((height, width, 3), jnp.float32),
        weight=jnp.zeros((height, width), jnp.float32),
        accum_sq=jnp.zeros((height, width), jnp.float32),
        spp=jnp.int32(0),
        fingerprint=fingerprint,
    )


def progressive_step(
    scene: SceneData,
    camera: Camera,
    params: RenderParams,
    width: int,
    height: int,
    state: Optional[ProgressiveState] = None,
    samples_per_step: int = 1,
) -> ProgressiveState:
    """Add `samples_per_step` budget passes, restarting on state change."""
    fp = state_fingerprint(scene, camera, params, width, height)
    if state is None or state.fingerprint != fp \
            or state.accum.shape[:2] != (height, width):
        state = init_state(width, height, fp)

    if params.adaptive and params.mode == RenderMode.GI:
        from cadrays_tpu.integrator.adaptive import (
            AdaptiveState,
            adaptive_round,
        )

        ast = AdaptiveState(
            accum=state.accum.reshape(-1, 3),
            accum_sq=state.accum_sq.reshape(-1),
            count=state.weight.reshape(-1),
            round=state.spp,
        )
        for _ in range(samples_per_step):
            ast = adaptive_round(scene, camera, params, width, height,
                                 params.tile_size, ast)
        return ProgressiveState(
            accum=ast.accum.reshape(height, width, 3),
            weight=ast.count.reshape(height, width),
            accum_sq=ast.accum_sq.reshape(height, width),
            spp=ast.round,
            fingerprint=fp,
        )

    if params.persistent and params.mode == RenderMode.GI:
        from cadrays_tpu.integrator.persistent import render_persistent

        # lane regeneration: ~1.5x sample throughput. The first pass
        # covers ~all quotas at the measured ~2.7-bounce average path
        # length; any under-completed pixel is TOPPED UP (the dropped
        # in-flight sample restarts from scratch) until cnt == spp, so
        # the accumulated estimator is the exact spp-sample mean with no
        # truncation selection bias (see persistent.py docstring).
        n_steps = samples_per_step * 4 + params.ray_depth
        sid_base = jnp.uint32(state.spp)
        sum_img, cnt = render_persistent(
            scene, camera, params, width, height, samples_per_step,
            n_steps, sid_base=sid_base)
        missing = int(samples_per_step - jnp.min(cnt))
        while missing > 0:
            # hard guarantee: m samples retire within m*ray_depth steps.
            # m is rounded up to the next power of two: n_steps is a
            # jit-static arg, so raw shortfall counts (1, 3, 2, ...)
            # would each compile a fresh full-scan XLA program —
            # bucketing bounds the compile set to log2(spp) variants
            m = 1 << (missing - 1).bit_length()
            top_img, top_cnt = render_persistent(
                scene, camera, params, width, height, samples_per_step,
                m * params.ray_depth, sid_base=sid_base,
                sid0=sid_base + cnt.astype(jnp.uint32), done0=cnt)
            sum_img = sum_img + top_img
            cnt = cnt + top_cnt
            missing = int(samples_per_step - jnp.min(cnt))
        return ProgressiveState(
            accum=state.accum + sum_img.reshape(height, width, 3),
            weight=state.weight
            + cnt.astype(jnp.float32).reshape(height, width),
            accum_sq=state.accum_sq,
            spp=state.spp + samples_per_step,
            fingerprint=fp,
        )

    img = render_image(scene, camera, params, width, height,
                       samples_per_step, jnp.uint32(state.spp))
    n = jnp.float32(samples_per_step)
    return ProgressiveState(
        accum=state.accum + img * n,
        weight=state.weight + n,
        accum_sq=state.accum_sq,
        spp=state.spp + samples_per_step,
        fingerprint=fp,
    )


def save_state(state: ProgressiveState, path: str) -> None:
    np.savez(path, accum=np.asarray(state.accum),
             weight=np.asarray(state.weight),
             accum_sq=np.asarray(state.accum_sq),
             spp=np.asarray(state.spp), fingerprint=state.fingerprint)


def load_state(path: str) -> ProgressiveState:
    z = np.load(path, allow_pickle=False)
    return ProgressiveState(
        accum=jnp.asarray(z["accum"]), weight=jnp.asarray(z["weight"]),
        accum_sq=jnp.asarray(z["accum_sq"]), spp=jnp.int32(z["spp"]),
        fingerprint=str(z["fingerprint"]),
    )
