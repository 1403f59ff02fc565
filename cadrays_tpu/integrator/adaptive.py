"""Adaptive screen-space sampling (tile-based), SPMD-safe.

Capability contract (reference SettingsWidget.cxx:427-484): adaptive
screen sampling redistributes the per-frame ray budget toward
high-variance tiles (tile count knob, debug tile view). On the reference
it is a GPU-vendor-gated OCCT feature; here it is a first-class part of
the integrator.

SPMD design (SURVEY.md §7.3 hard part #6 "adaptive tiling under SPMD"):
devices run one program on static shapes, so per-tile *variable* work is
forbidden. Instead
every adaptive round spends a **fixed budget of S = W*H sample slots**;
what varies is the slot->pixel mapping, computed on-device from the
accumulated per-tile error:

  1. per-pixel variance proxy from (sum, sum_sq, count) accumulators;
  2. per-tile error = mean relative variance (tent-weighted toward
     under-sampled tiles);
  3. integer allocation of S slots proportional to error (largest-
     remainder rounding) — pure jnp, no host sync;
  4. slot s -> tile via searchsorted(cumsum(alloc)), pixel via
     round-robin within the tile;
  5. render_sample on the slot pixel ids; scatter-add radiance and
     counts with segment_sum.

Shapes are static; the mapping is data. The same machinery runs under
shard_map by sharding the slot axis.
"""
from __future__ import annotations

from functools import partial

from cadrays_tpu.utils import struct
import jax
import jax.numpy as jnp

from cadrays_tpu.core.camera import Camera
from cadrays_tpu.core.vecmath import luminance
from cadrays_tpu.integrator.params import RenderParams
from cadrays_tpu.integrator.wavefront import render_sample
from cadrays_tpu.scene.flatten import SceneData


@struct.dataclass
class AdaptiveState:
    accum: jnp.ndarray  # (H*W, 3) radiance sum
    accum_sq: jnp.ndarray  # (H*W,) luminance^2 sum
    count: jnp.ndarray  # (H*W,) samples per pixel
    round: jnp.ndarray  # scalar int32

    @property
    def image_flat(self) -> jnp.ndarray:
        return self.accum / jnp.maximum(self.count[..., None], 1.0)

    def image(self, width: int, height: int) -> jnp.ndarray:
        return self.image_flat.reshape(height, width, 3)


def init_adaptive(width: int, height: int) -> AdaptiveState:
    n = width * height
    return AdaptiveState(
        accum=jnp.zeros((n, 3), jnp.float32),
        accum_sq=jnp.zeros((n,), jnp.float32),
        count=jnp.zeros((n,), jnp.float32),
        round=jnp.int32(0),
    )


def _tile_grid(width: int, height: int, tile: int):
    tx = -(-width // tile)
    ty = -(-height // tile)
    return tx, ty


def tile_errors(state: AdaptiveState, width: int, height: int,
                tile: int) -> jnp.ndarray:
    """Per-tile relative-variance error map, shape (ty*tx,)."""
    tx, ty = _tile_grid(width, height, tile)
    n = jnp.maximum(state.count, 1.0)
    mean = luminance(state.accum) / n
    var = jnp.maximum(state.accum_sq / n - mean * mean, 0.0)
    # relative std error of the mean (Dammertz-style stopping criterion)
    err_px = jnp.sqrt(var / n) / jnp.maximum(mean, 1e-2)
    # never starve a pixel: floor on the error of low-count pixels
    err_px = jnp.where(state.count < 4.0, 1.0, err_px)
    err_img = err_px.reshape(height, width)
    pad_y = ty * tile - height
    pad_x = tx * tile - width
    err_img = jnp.pad(err_img, ((0, pad_y), (0, pad_x)))
    tiles = err_img.reshape(ty, tile, tx, tile).mean(axis=(1, 3))
    return tiles.reshape(-1)


def allocate_slots(err: jnp.ndarray, budget: int) -> jnp.ndarray:
    """Integer slot counts per tile summing exactly to `budget`
    (largest-remainder method, fully on-device)."""
    w = err / jnp.maximum(jnp.sum(err), 1e-12)
    ideal = w * budget
    base = jnp.floor(ideal).astype(jnp.int32)
    rem = budget - jnp.sum(base)
    frac = ideal - base
    # give the `rem` largest fractions one extra slot
    order = jnp.argsort(-frac)
    ranks = jnp.zeros_like(order).at[order].set(
        jnp.arange(order.shape[0], dtype=jnp.int32))
    extra = (ranks < rem).astype(jnp.int32)
    return base + extra


def slots_to_pixels(alloc: jnp.ndarray, width: int, height: int,
                    tile: int, round_id) -> jnp.ndarray:
    """Map S = W*H sample slots to pixel ids per the tile allocation."""
    tx, ty = _tile_grid(width, height, tile)
    S = width * height
    cum = jnp.cumsum(alloc)
    slot = jnp.arange(S, dtype=jnp.int32)
    t = jnp.searchsorted(cum, slot, side="right").astype(jnp.int32)
    t = jnp.clip(t, 0, alloc.shape[0] - 1)
    within = slot - jnp.where(t > 0, cum[t - 1], 0)
    # round-robin over the tile's pixels, rotated per round for coverage
    P = tile * tile
    j = (within + round_id * 7919) % P
    tyx, txx = t // tx, t % tx
    py = tyx * tile + j // tile
    px = txx * tile + j % tile
    # clamp edge tiles into the image
    py = jnp.minimum(py, height - 1)
    px = jnp.minimum(px, width - 1)
    return py * width + px


@partial(jax.jit, static_argnames=("width", "height", "tile"))
def adaptive_round(scene: SceneData, camera: Camera, params: RenderParams,
                   width: int, height: int, tile: int,
                   state: AdaptiveState) -> AdaptiveState:
    """One fixed-budget adaptive pass: W*H samples, variance-guided."""
    err = tile_errors(state, width, height, tile)
    alloc = allocate_slots(err, width * height)
    pids = slots_to_pixels(alloc, width, height, tile, state.round)
    # decorrelate re-visited pixels via the running per-pixel count
    sample_id = state.count[pids].astype(jnp.uint32) + state.round.astype(
        jnp.uint32) * jnp.uint32(977)
    rad = render_sample(scene, camera, params, width, height, sample_id,
                        pixel_ids=pids)
    n = width * height
    accum = state.accum.at[pids].add(rad)
    lum = luminance(rad)
    accum_sq = state.accum_sq.at[pids].add(lum * lum)
    count = state.count.at[pids].add(1.0)
    return AdaptiveState(accum=accum, accum_sq=accum_sq, count=count,
                         round=state.round + 1)


def debug_tile_map(state: AdaptiveState, width: int, height: int,
                   tile: int) -> jnp.ndarray:
    """Per-pixel normalized sample-density map — the reference's debug
    tile view (SettingsWidget.cxx:443-449)."""
    c = state.count.reshape(height, width)
    return c / jnp.maximum(jnp.max(c), 1.0)


def debug_tile_overlay(count, width: int, height: int):
    """Sample-density heatmap image (H, W, 3): blue (cold, few samples)
    -> red (hot, many) — what the reference's "Show sampling tiles"
    checkbox renders over the viewport (SettingsWidget.cxx:443-449)."""
    import jax.numpy as jnp

    c = jnp.asarray(count).reshape(height, width)
    t = c / jnp.maximum(jnp.max(c), 1.0)
    r = jnp.clip(2.0 * t - 0.5, 0.0, 1.0)
    g = 1.0 - jnp.abs(2.0 * t - 1.0)
    b = jnp.clip(1.0 - 2.0 * t, 0.0, 1.0)
    return jnp.stack([r, g, b], axis=-1)
