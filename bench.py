#!/usr/bin/env python
"""Headline benchmark: samples/s, forward+backward, 1024x1024 Cornell.

Runs on one GPU in one process and exits non-zero without one. Prints the
device (JAX's platform and device kind, and nvidia-smi's name and power
limit), then ONE JSON line:
  {"metric": "...", "value": N, "unit": "samples/s", ...}

The path is the persistent wavefront (integrator/persistent.py), the
renderer's default GI path. Every lane (pixel) gets the same sample
quota `spp`, the scan runs `T` bounce steps, and the rate divides the
samples the device completed by the wall time of one jitted call that
ends in `block_until_ready` (best of three, after a warm-up call that
compiles). Quota still in flight at the scan cut-off is not counted.

  issued rate = completed samples/s x depth x 2 (nominal queries per
                sample: 1 closest + 1 NEE shadow per bounce)
  active rate = measured live-lane bounces x 2 / time
"""
from __future__ import annotations

import argparse
import json
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=4,
                    help="the rendered lanes are 1/chunks of the frame "
                         "(backward-pass memory)")
    ap.add_argument("--quick", action="store_true",
                    help="small config for smoke testing")
    ap.add_argument("--fwd-only", action="store_true")
    args = ap.parse_args()

    from cadrays_tpu.utils.compile_cache import configure_compile_cache
    from cadrays_tpu.utils.device import nvidia_smi_name_power, require_gpu

    configure_compile_cache()
    dev = require_gpu()
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}")
    print(nvidia_smi_name_power(), flush=True)

    import jax
    import jax.numpy as jnp

    from cadrays_tpu.diff.optimize import l2_image_loss
    from cadrays_tpu.integrator.params import RenderParams
    from cadrays_tpu.integrator.persistent import render_persistent
    from cadrays_tpu.testing.scenes import cornell_box, cornell_camera

    if args.quick:
        args.res, args.chunks = 128, 1
    cam = cornell_camera()
    data = cornell_box(full=True, sphere_res=24).flatten(cam)
    params = RenderParams(ray_depth=args.depth)

    W = H = args.res
    R = (W * H) // args.chunks
    pids = jnp.arange(R, dtype=jnp.int32)
    spp = 4 if args.quick else 32
    T = spp * 3
    fwd_only = args.fwd_only

    @jax.jit
    def run(scene):
        if fwd_only:
            img, cnt, alive = render_persistent(
                scene, cam, params, W, H, spp, T, pixel_ids=pids,
                return_stats=True)
            return jnp.sum(cnt), jnp.sum(alive), jnp.sum(img)

        def loss_fn(s):
            img, cnt, alive = render_persistent(
                s, cam, params, W, H, spp, T, pixel_ids=pids,
                return_stats=True)
            img = img / jnp.maximum(cnt[:, None].astype(jnp.float32), 1.0)
            return (l2_image_loss(img, jnp.zeros_like(img)),
                    (jnp.sum(cnt), jnp.sum(alive)))

        (loss, (cnt, alive)), g = jax.value_and_grad(
            loss_fn, has_aux=True, allow_int=True)(scene)
        return cnt, alive, loss + jnp.sum(g.materials.kd)

    t0 = time.perf_counter()
    jax.block_until_ready(run(data))
    setup_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        cnt, alive, chk = jax.block_until_ready(run(data))
        best = min(best, time.perf_counter() - t0)
    if not bool(jnp.isfinite(chk)):
        raise SystemExit("non-finite render or gradient")

    samples_per_s = int(cnt) / best
    issued_per_s = samples_per_s * args.depth * 2
    active_per_s = int(alive) * 2 / best
    mode = "fwd" if fwd_only else "fwd+bwd"
    print(json.dumps({
        "metric": (f"samples/s {mode} {args.res}x{args.res} Cornell "
                   f"depth={args.depth}"),
        "value": samples_per_s,
        "unit": "samples/s",
        "device": dev,
        "seconds": best,
        "setup_seconds": setup_s,
        "issued_rays_per_s": issued_per_s,
        "active_rays_per_s": active_per_s,
        "quota_completion": int(cnt) / (R * spp),
        "renderer": f"persistent wavefront, quota spp={spp} T={T}",
    }))


if __name__ == "__main__":
    main()
