"""256x256 golden gate.

The 64x64 goldens can hide DoF bokeh shape, texture filtering, BVH
ordering and env-CDF regressions inside their 2% pixel budget; these
256x256 goldens cover three feature axes the small set does not pin
down: the full Cornell at 4x resolution, an instanced-TLAS scene
(two-level traversal), and an environment-map scene (marginal/
conditional CDF importance sampling + background). Deterministic
counter-based RNG keeps the gate tight.

Update with:  CADRAYS_GOLDEN_UPDATE=1 python -m pytest
              tests/test_golden_hires.py -q

The goldens were recorded on the CPU. `chip_smoke.py` (phase 6) renders
the same scenes on the GPU, through the CUDA traversal kernel, and holds
them to the same `compare` budget.
"""
import os

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DATA = os.path.join(os.path.dirname(__file__), "data")
RES = 256
SPP = 8
# a pixel is bad when any channel is off by more than PIXEL_TOL; a scene
# passes while fewer than BAD_PIXEL_BUDGET of its pixels are bad
PIXEL_TOL = 0.02
BAD_PIXEL_BUDGET = 0.005


def _render(data, cam, params):
    import jax

    from cadrays_tpu.integrator.progressive import progressive_step

    st = progressive_step(data, cam, params, RES, RES, None, 1)
    st = progressive_step(data, cam, params, RES, RES, st,
                          samples_per_step=SPP - 1)
    jax.block_until_ready(st.accum)
    return np.asarray(st.image)


def _scene_cornell():
    from cadrays_tpu.integrator.params import RenderParams
    from cadrays_tpu.testing.scenes import cornell_box, cornell_camera

    scene = cornell_box(full=True, sphere_res=24)
    cam = cornell_camera()
    return scene.flatten(cam), cam, RenderParams(ray_depth=5)


def _scene_instanced():
    from cadrays_tpu.core.bsdf import material
    from cadrays_tpu.core.camera import Camera
    from cadrays_tpu.core.lights import concat_lights, positional_light
    from cadrays_tpu.geometry.primitives import torus
    from cadrays_tpu.integrator.params import RenderParams
    from cadrays_tpu.scene.instances import build_instanced

    mesh = torus(0.5, 0.2, 24, 12)
    meshes, tfs, mids = [], [], []
    for i in range(3):
        for j in range(3):
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = (i * 1.4, j * 1.4, 0.3 * ((i + j) % 2))
            meshes.append(mesh)
            tfs.append(m)
            mids.append((i + j) % 2)
    mats = [material(kd=(0.8, 0.3, 0.2)),
            material(kd=(0.2, 0.4, 0.9), ks=(0.3, 0.3, 0.3),
                     base_rough=0.2)]
    lights = concat_lights([positional_light(position=(1.4, 1.4, 4.0),
                                             intensity=60.0,
                                             smooth_radius=0.2)])
    data = build_instanced(meshes, tfs, mats, mids, lights=lights)
    cam = Camera.look_at(eye=(1.4, -3.0, 2.5), at=(1.4, 1.4, 0.0),
                         up=(0, 0, 1), fovy_deg=45.0)
    return data, cam, RenderParams(ray_depth=4)


def _scene_envmap():
    from cadrays_tpu.core.bsdf import material
    from cadrays_tpu.core.camera import Camera
    from cadrays_tpu.geometry.primitives import sphere
    from cadrays_tpu.integrator.params import RenderParams
    from cadrays_tpu.scene.scene import Scene

    # procedural HDR: bright horizontal band + hot "sun" disk exercises
    # both CDF axes of the importance sampler
    h, w = 64, 128
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = 0.1 + 0.6 * np.exp(-((yy - 20.0) / 6.0) ** 2)[..., None] \
        * np.ones((h, w, 3))
    sun = np.exp(-(((yy - 14.0) / 2.5) ** 2 + ((xx - 90.0) / 2.5) ** 2))
    img = img + 40.0 * sun[..., None] * np.array([1.0, 0.9, 0.7])
    scene = Scene()
    scene.clear_lights()
    scene.set_envmap(img.astype(np.float32), intensity=1.0,
                     background=True)
    scene.add_shape("ball", sphere(0.5, 32, 16),
                    material(kd=(0.6, 0.6, 0.6), ks=(0.2, 0.2, 0.2),
                             base_rough=0.15))
    scene.add_shape("mirror", sphere(0.35, 32, 16),
                    material(kd=(0.02, 0.02, 0.02), ks=(0.9, 0.9, 0.9),
                             base_rough=0.02),
                    np.array([[1, 0, 0, 0.9], [0, 1, 0, -0.4],
                              [0, 0, 1, 0.0], [0, 0, 0, 1]], np.float32))
    cam = Camera.look_at(eye=(0.0, -2.6, 0.6), at=(0.3, 0.0, 0.0),
                         up=(0, 0, 1), fovy_deg=40.0)
    return scene.flatten(cam), cam, RenderParams(ray_depth=4)


SCENES = {
    "hires_cornell": _scene_cornell,
    "hires_instanced": _scene_instanced,
    "hires_envmap": _scene_envmap,
}


VARIANTS = ("fixed", "persistent")


def render_scene(name: str, variant: str) -> np.ndarray:
    """Render golden scene `name` with the fixed-depth or the persistent
    wavefront."""
    data, cam, params = SCENES[name]()
    params = params.replace(persistent=(variant == "persistent"))
    return _render(data, cam, params)


def golden_path(name: str, variant: str) -> str:
    # `hires_<name>.npz` holds the fixed-depth wavefront's image and
    # `hires_<name>_persistent.npz` the persistent one's: the two
    # estimators are statistically, not bitwise, equal.
    suffix = "_persistent" if variant == "persistent" else ""
    return os.path.join(GOLDEN, f"{name}{suffix}.npz")


def compare(img: np.ndarray, golden: np.ndarray) -> dict:
    """Bad-pixel share and error statistics of `img` against `golden`."""
    err = np.abs(img - golden)
    bad = np.any(err > PIXEL_TOL, axis=-1)
    return {"bad": float(bad.mean()), "mean_err": float(err.mean()),
            "max_err": float(err.max())}


@pytest.mark.slow
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_golden_hires(name, variant):
    img = render_scene(name, variant)
    assert np.isfinite(img).all()
    path = golden_path(name, variant)
    if os.environ.get("CADRAYS_GOLDEN_UPDATE") or not os.path.exists(path):
        np.savez_compressed(path, image=img.astype(np.float16))
        if not os.environ.get("CADRAYS_GOLDEN_UPDATE"):
            pytest.skip(f"golden for {name} created; rerun to gate")
        return
    c = compare(img, np.load(path)["image"].astype(np.float32))
    assert c["bad"] < BAD_PIXEL_BUDGET, (
        f"{name}: {c['bad'] * 100:.2f}% pixels off "
        f"(mean {c['mean_err']:.4f}, max {c['max_err']:.3f})")
