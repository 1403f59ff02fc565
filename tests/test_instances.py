"""Two-level (TLAS/BLAS) instanced traversal: equality with baked scenes."""
import jax.numpy as jnp
import numpy as np
import pytest

from cadrays_tpu.integrator.params import RenderParams
from cadrays_tpu.integrator.renderer import render_image
from cadrays_tpu.ops.traverse import trace_gather
from cadrays_tpu.testing.scenes import cornell_box, cornell_camera

RES = 24


@pytest.fixture(scope="module")
def both_scenes():
    cam = cornell_camera()
    baked = cornell_box(full=False).flatten(cam)
    inst = cornell_box(full=False).flatten(cam, instancing=True)
    return baked, inst, cam


class TestInstancedTraversal:
    def test_same_triangle_count(self, both_scenes):
        baked, inst, _ = both_scenes
        assert baked.geometry.num_triangles == inst.geometry.num_triangles
        assert inst.geometry.instanced and not baked.geometry.instanced

    def test_hits_match_baked(self, both_scenes):
        baked, inst, cam = both_scenes
        rs = np.random.RandomState(2)
        R = 600
        o = np.float32([0.5, -1.5, 0.5]) + 0.05 * rs.randn(R, 3).astype(
            np.float32)
        d = np.float32([0, 1, 0]) + 0.5 * rs.randn(R, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = jnp.full(R, 1e30)
        a = trace_gather(baked.geometry, jnp.asarray(o), jnp.asarray(d), tmax)
        b = trace_gather(inst.geometry, jnp.asarray(o), jnp.asarray(d), tmax)
        # triangle ids are permuted between builds; compare hit masks
        # and distances
        np.testing.assert_array_equal(np.asarray(a["tri"]) >= 0,
                                      np.asarray(b["tri"]) >= 0)
        np.testing.assert_allclose(np.asarray(a["t"]),
                                   np.asarray(b["t"]), rtol=2e-4,
                                   atol=2e-4)

    def test_render_matches_baked(self, both_scenes):
        """Full GI render through the instanced path matches the baked
        scene (same RNG, same estimator; only tri indexing differs)."""
        baked, inst, cam = both_scenes
        params = RenderParams(ray_depth=3)
        img_b = np.asarray(render_image(baked, cam, params, RES, RES, 8))
        img_i = np.asarray(render_image(inst, cam, params, RES, RES, 8))
        # identical hits except float-epsilon silhouette flips
        bad = np.any(np.abs(img_i - img_b) > 5e-3, axis=-1)
        assert bad.mean() < 0.005, bad.mean()

    def test_nonuniform_scale_instance(self):
        """Instance with non-uniform scale: normals and t must be correct
        (inverse-transpose normals, world-parameterized t)."""
        from cadrays_tpu.core.bsdf import material
        from cadrays_tpu.core.camera import Camera
        from cadrays_tpu.core.lights import directional_light
        from cadrays_tpu.geometry import primitives
        from cadrays_tpu.scene.scene import Scene

        def build(instancing):
            sc = Scene()
            sc.clear_lights()
            sc.add_light(directional_light(direction=(0, 0, -1),
                                           intensity=2.0))
            tf = np.diag([3.0, 1.0, 0.5, 1.0]).astype(np.float32)
            sc.add_mesh("squashed", primitives.sphere(1.0, 24, 12),
                        material(kd=(0.7, 0.7, 0.7)), tf)
            cam = Camera.look_at(eye=(0, 0, 6), at=(0, 0, 0), up=(0, 1, 0),
                                 fovy_deg=45.0)
            return sc.flatten(cam, instancing=instancing), cam

        db, cam = build(False)
        di, _ = build(True)
        params = RenderParams(ray_depth=2)
        img_b = np.asarray(render_image(db, cam, params, RES, RES, 8))
        img_i = np.asarray(render_image(di, cam, params, RES, RES, 8))
        # a scaled sphere is nearly all silhouette at this resolution —
        # allow up to 2% of pixels to flip hit ids at edges
        bad = np.any(np.abs(img_i - img_b) > 5e-3, axis=-1)
        assert bad.mean() < 0.02, bad.mean()

    def test_emissive_instanced(self):
        from cadrays_tpu.testing.scenes import emissive_quad_scene
        from cadrays_tpu.core.camera import Camera

        sc = emissive_quad_scene(le=(8.0, 8.0, 8.0))
        cam = Camera.look_at(eye=(0, -0.01, 6), at=(0, 0, 0), up=(0, 1, 0),
                             fovy_deg=30.0)
        di = sc.flatten(cam, instancing=True)
        assert di.emissive.count > 0
        params = RenderParams(ray_depth=3)
        img = np.asarray(render_image(di, cam, params, 32, 32, 16))
        assert img[16, 24:30].mean() > 0.05  # floor lit through instancing
