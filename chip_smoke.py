#!/usr/bin/env python
"""Prove the path tracer's main path on one NVIDIA GPU, in one process.

    python chip_smoke.py          # phases 1-6 on one card
    python chip_smoke.py --four   # phase 7 only, on a 4-card host

Phases (every one must pass; the first failure ends the run non-zero):
  1. device check: JAX's first device is a GPU; prints the card's name
     and power limit as nvidia-smi gives them.
  2. build: the native BVH builder (g++) and the CUDA traversal (nvcc).
  3. traversal kernel against the reference gather walk (XLA), 262,144
     primary and sorted bounce rays on Cornell and on the 611k-triangle
     distinct-parts assembly, closest-hit and any-hit, with timings.
  4. main path: the batch CLI (`cadrays_tpu.cli.render.main`) on
     tests/data/cornell.crt at 1024x1024, 16 spp (persistent wavefront),
     and `Renderer(RenderParams(ray_depth=5)).render` on the assembly at
     1024x1024.
  5. inverse rendering: 3 gradient steps at 256x256 on Cornell, forward
     and backward through the persistent wavefront.
  6. cross-backend goldens: tests/test_golden_hires.py's scenes rendered
     here against its CPU-recorded images, with its `compare` budget.
  7. (--four only) the sharded persistent render, forward plus gradient,
     on a 4-card mesh against a 1-card mesh.

The last line of standard output is the result, and nothing else:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "smoke")
N_RAYS = 262_144  # 1024 x 1024 / 4
TRI_AGREE = 0.9999  # share of lanes whose closest triangle must agree
OCC_AGREE = 0.9999  # share of lanes whose occlusion bit must agree
ATTR_TOL = 1e-5  # t, u, v: absolute or relative


def result_line(device: dict) -> str:
    """The contract's last line for `device` (platform, kind, count)."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _timed(fn, *args, reps: int = 5) -> float:
    """Median wall seconds of `fn(*args)` after one warm-up call."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_build() -> None:
    from cadrays_tpu.native.build import build as build_native
    from cadrays_tpu.ops.traverse_cuda import build as build_cuda, load

    t0 = time.perf_counter()
    check(build_native(force=True), "native BVH builder failed to build")
    print(f"native BVH library (g++): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    build_cuda(force=True)
    print(f"CUDA traversal library (nvcc sm_90a): "
          f"{time.perf_counter() - t0:.2f} s")
    load()


def compare_closest(k: dict, g: dict, tag: str) -> None:
    """Kernel `k` against reference `g`: triangle ids on >= TRI_AGREE of
    lanes; where they differ (grazing ties), t to ATTR_TOL relative;
    where they agree, t, u, v to ATTR_TOL absolute or relative."""
    import numpy as np

    k = {n: np.asarray(v) for n, v in k.items()}
    g = {n: np.asarray(v) for n, v in g.items()}
    same = k["tri"] == g["tri"]
    agree = float(same.mean())
    tie_err = float((np.abs(k["t"] - g["t"])
                     / np.maximum(np.abs(g["t"]), 1e-30))[~same].max(
                         initial=0.0))
    attr_err = {n: float((np.abs(k[n] - g[n])
                          / np.maximum(1.0, np.abs(g[n])))[same].max(
                              initial=0.0)) for n in ("t", "u", "v")}
    print(f"  {tag}: tri agree {agree:.6f} ({int((~same).sum())} lanes "
          f"differ, t rel err there {tie_err:.3g}); max err where equal "
          f"t {attr_err['t']:.3g} u {attr_err['u']:.3g} "
          f"v {attr_err['v']:.3g}; hits {int((g['tri'] >= 0).sum())}")
    check(agree >= TRI_AGREE, f"{tag}: triangle ids agree on {agree}")
    check(tie_err <= ATTR_TOL, f"{tag}: t differs by {tie_err} at ties")
    for n, e in attr_err.items():
        check(e <= ATTR_TOL, f"{tag}: {n} differs by {e}")


def phase_kernel(scenes_: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cadrays_tpu.ops.traverse import trace_gather
    from cadrays_tpu.ops.traverse_cuda import trace_cuda
    from cadrays_tpu.testing.scenes import bounce_rays, primary_rays

    print(f"precision: float32 throughout; jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision}; the reference's "
          f"instance transforms are einsums pinned to precision='float32' "
          f"(no TF32) and the kernel does no matrix products")
    kernel = jax.jit(trace_cuda, static_argnames=("any_hit",))
    for name, (data, cam) in scenes_.items():
        geom = data.geometry
        o, d = primary_rays(cam, 1024, 1024, stride=4)
        check(o.shape[0] == N_RAYS, f"{o.shape[0]} rays")
        t_max = jnp.full((N_RAYS,), 1e30, jnp.float32)
        ob, db = bounce_rays(geom, o, d, kernel(geom, o, d, t_max))
        for kind, (ro, rd) in (("primary", (o, d)), ("bounce", (ob, db))):
            for any_hit in (False, True):
                tag = (f"{name} {kind} "
                       f"{'any-hit' if any_hit else 'closest'}")
                k = kernel(geom, ro, rd, t_max, any_hit=any_hit)
                g = trace_gather(geom, ro, rd, t_max, any_hit=any_hit)
                if any_hit:
                    occ = float(np.mean((np.asarray(k["tri"]) >= 0)
                                        == (np.asarray(g["tri"]) >= 0)))
                    print(f"  {tag}: occlusion agree {occ:.6f}")
                    check(occ >= OCC_AGREE, f"{tag}: occlusion {occ}")
                else:
                    compare_closest(k, g, tag)
                tk = _timed(lambda *a: kernel(*a, any_hit=any_hit),
                            geom, ro, rd, t_max)
                tg = _timed(lambda *a: trace_gather(*a, any_hit=any_hit),
                            geom, ro, rd, t_max, reps=3)
                print(f"  {tag}: kernel {tk * 1e3:.3f} ms "
                      f"({N_RAYS / tk / 1e6:.1f} Mray/s), gather "
                      f"{tg * 1e3:.3f} ms ({N_RAYS / tg / 1e6:.1f} Mray/s)",
                      flush=True)


def phase_main_path(assembly) -> None:
    import jax
    import numpy as np

    from cadrays_tpu.cli.render import main as render_main
    from cadrays_tpu.integrator.params import RenderParams
    from cadrays_tpu.integrator.renderer import Renderer
    from cadrays_tpu.utils.image import read_hdr

    os.makedirs(OUT_DIR, exist_ok=True)
    script = os.path.join(ROOT, "tests", "data", "cornell.crt")
    hdr_path = os.path.join(OUT_DIR, "cornell_1024.hdr")
    argv = [script, "--res", "1024", "1024", "--spp", "16",
            "--out", os.path.join(OUT_DIR, "cornell_1024.png"),
            "--hdr", hdr_path]
    for run in ("first (compiles)", "second"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = render_main(argv)
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli.render exited {rc}")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"  cli.render cornell.crt 1024x1024 16 spp, {run} run: "
              f"{line['spp_per_s']} spp/s, render {line['seconds']} s, "
              f"wall {wall:.2f} s")
    img = read_hdr(hdr_path)
    mean = float(img.mean())
    print(f"  cornell hdr: shape {img.shape} mean {mean:.4f}")
    check(img.shape == (1024, 1024, 3), f"cornell shape {img.shape}")
    check(bool(np.isfinite(img).all()), "cornell image not finite")
    check(0.2 <= mean <= 0.4, f"cornell hdr mean {mean} not in [0.2, 0.4]")

    data, cam = assembly
    spp = 4
    r = Renderer(RenderParams(ray_depth=5))
    t0 = time.perf_counter()
    jax.block_until_ready(r.render(data, cam, 1024, 1024, spp=spp))
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = np.asarray(jax.block_until_ready(
        r.render(data, cam, 1024, 1024, spp=spp)))
    dt = time.perf_counter() - t0
    print(f"  Renderer assembly 1024x1024 depth 5 {spp} spp: first call "
          f"{setup:.2f} s, then {dt:.3f} s = {spp / dt:.3f} spp/s "
          f"({spp * 1024 * 1024 / dt:.4g} samples/s); mean "
          f"{float(img.mean()):.4f}")
    check(img.shape == (1024, 1024, 3), f"assembly shape {img.shape}")
    check(bool(np.isfinite(img).all()), "assembly image not finite")
    check(float(img.mean()) > 0.0, "assembly image is black")


def phase_inverse(cornell, res: int = 256) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from cadrays_tpu.diff.optimize import l2_image_loss
    from cadrays_tpu.integrator.params import RenderParams
    from cadrays_tpu.integrator.persistent import render_persistent

    data, cam = cornell
    W = H = res
    spp, params = 4, RenderParams(ray_depth=5)
    n_steps = spp * 4 + params.ray_depth

    def render(scene):
        img, cnt = render_persistent(scene, cam, params, W, H, spp, n_steps)
        return img / jnp.maximum(cnt[:, None].astype(jnp.float32), 1.0)

    # the target is the scene itself; the fit starts from darker albedos
    target = jax.jit(render)(data)
    start = data.replace(materials=data.materials.replace(
        kd=data.materials.kd * 0.6))
    opt = optax.sgd(0.5)

    @jax.jit
    def step(kd, state):
        def loss_fn(kd_):
            s = start.replace(materials=start.materials.replace(kd=kd_))
            return l2_image_loss(render(s), target)

        loss, g = jax.value_and_grad(loss_fn)(kd)
        upd, state = opt.update(g, state, kd)
        return optax.apply_updates(kd, upd), state, loss, g

    kd, state = start.materials.kd, opt.init(start.materials.kd)
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        kd, state, loss, g = jax.block_until_ready(step(kd, state))
        losses.append(float(loss))
        gn = float(jnp.linalg.norm(g))
        print(f"  step {i}: loss {losses[-1]:.6g} |grad kd| {gn:.4g} "
              f"({time.perf_counter() - t0:.2f} s)")
        check(np.isfinite(losses[-1]), f"loss {losses[-1]}")
        check(bool(jnp.isfinite(g).all()) and gn > 0.0,
              "gradient not finite or zero")
    check(all(b <= a for a, b in zip(losses, losses[1:])),
          f"loss increased: {losses}")


def phase_goldens() -> None:
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_golden_hires as gh

    for name in sorted(gh.SCENES):
        for variant in gh.VARIANTS:
            img = gh.render_scene(name, variant)
            check(bool(np.isfinite(img).all()), f"{name} {variant} NaN")
            golden = np.load(gh.golden_path(name, variant))["image"]
            c = gh.compare(img, golden.astype(np.float32))
            print(f"  {name} {variant}: {c['bad'] * 100:.3f}% bad pixels "
                  f"(budget {gh.BAD_PIXEL_BUDGET * 100:.1f}%), mean err "
                  f"{c['mean_err']:.4f}, max {c['max_err']:.3f}",
                  flush=True)
            check(c["bad"] < gh.BAD_PIXEL_BUDGET,
                  f"{name} {variant}: {c['bad']} bad pixels")


def phase_four(cornell, res: int = 256) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cadrays_tpu.diff.optimize import l2_image_loss
    from cadrays_tpu.integrator.params import RenderParams
    from cadrays_tpu.parallel.sharding import (make_mesh,
                                               render_persistent_sharded,
                                               scene_replicated)

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, not 4")
    data, cam = cornell
    W = H = res
    spp, params = 4, RenderParams(ray_depth=5)
    n_steps = spp * 4 + params.ray_depth

    def fwd_grad(mesh):
        scene = scene_replicated(data, mesh)
        devices = set(mesh.devices.flat)
        for leaf in jax.tree.leaves(scene):
            shards = leaf.addressable_shards
            check({s.device for s in shards} == devices,
                  "scene leaf not on every card")
            # bytes, not values: packed tables hold bit-cast integers
            ref = np.asarray(shards[0].data).tobytes()
            check(all(np.asarray(s.data).tobytes() == ref for s in shards),
                  "scene replicas differ")

        @jax.jit
        def run(scene_):
            def loss_fn(s):
                img, cnt = render_persistent_sharded(
                    s, cam, params, W, H, spp, n_steps, mesh)
                img = img[:W * H] / jnp.maximum(
                    cnt[:W * H, None].astype(jnp.float32), 1.0)
                return l2_image_loss(img, jnp.zeros_like(img)), img

            (loss, img), g = jax.value_and_grad(
                loss_fn, has_aux=True, allow_int=True)(scene_)
            return loss, img, g.materials.kd

        jax.block_until_ready(run(scene))
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(scene))
        print(f"  {mesh.devices.size}-card mesh: fwd+grad "
              f"{time.perf_counter() - t0:.3f} s, loss {float(out[0]):.6g}")
        return [np.asarray(x) for x in out]

    loss4, img4, g4 = fwd_grad(make_mesh(4))
    loss1, img1, g1 = fwd_grad(make_mesh(1))
    img_err = float(np.abs(img4 - img1).max())
    g_err = float(np.abs(g4 - g1).max() / max(np.abs(g1).max(), 1e-30))
    print(f"  4 vs 1 card: image max abs diff {img_err:.3g}, loss "
          f"{float(loss4):.8g} vs {float(loss1):.8g}, grad kd max rel "
          f"diff {g_err:.3g}")
    check(np.isfinite(img4).all() and np.isfinite(g4).all(), "non-finite")
    check(img_err <= 1e-5, f"images differ by {img_err}")
    check(g_err <= 1e-4, f"gradients differ by {g_err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    from cadrays_tpu.utils.compile_cache import configure_compile_cache
    from cadrays_tpu.utils.device import nvidia_smi_name_power, require_gpu

    configure_compile_cache()
    with phase("1 device"):
        dev = require_gpu()
        print(f"  jax: {dev['platform']} {dev['kind']} x{dev['count']}")
        print(nvidia_smi_name_power())

    from cadrays_tpu.testing.scenes import (cornell_box, cornell_camera,
                                            distinct_parts_assembly)

    cam = cornell_camera()
    cornell = (cornell_box(full=True).flatten(cam), cam)
    if args.four:
        with phase("7 four cards"):
            phase_four(cornell)
        print(result_line(dev))
        return 0

    with phase("2 build"):
        phase_build()
    t0 = time.perf_counter()
    assembly = distinct_parts_assembly()
    print(f"distinct-parts assembly: "
          f"{assembly[0].geometry.num_triangles} triangles, "
          f"{assembly[0].geometry.inst_inv.shape[0]} parts, built in "
          f"{time.perf_counter() - t0:.1f} s")
    with phase("3 kernel vs reference"):
        phase_kernel({"cornell": cornell, "assembly": assembly})
    with phase("4 main path"):
        phase_main_path(assembly)
    with phase("5 inverse rendering"):
        phase_inverse(cornell)
    with phase("6 cross-backend goldens"):
        phase_goldens()
    print(result_line(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
