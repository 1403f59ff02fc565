"""utils.struct: frozen dataclass pytrees with static fields."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cadrays_tpu.utils import struct


@struct.dataclass
class _Pair:
    x: jnp.ndarray
    scale: float = struct.field(pytree_node=False, default=2.0)


def test_static_fields_retrace_and_traced_fields_do_not():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.scale)
        return p.x * p.scale

    np.testing.assert_allclose(f(_Pair(jnp.ones(3))), 2.0)
    np.testing.assert_allclose(f(_Pair(jnp.ones(3) * 5.0)), 10.0)
    assert traces == [2.0]  # new leaf values: no retrace
    np.testing.assert_allclose(f(_Pair(jnp.ones(3), scale=3.0)), 3.0)
    assert traces == [2.0, 3.0]  # new static value: retrace


def test_leaves_and_treedef():
    p = _Pair(jnp.arange(2.0), scale=4.0)
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 1
    q = jax.tree.unflatten(treedef, [jnp.zeros(2)])
    assert q.scale == 4.0 and isinstance(q, _Pair)
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_leaves_with_path(p)]
    assert paths == [".x"]


def test_replace_and_frozen():
    p = _Pair(jnp.ones(2))
    q = p.replace(scale=7.0)
    assert q.scale == 7.0 and p.scale == 2.0 and q.x is p.x
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.scale = 1.0


def _lights():
    from cadrays_tpu.core.lights import positional_light

    return positional_light(position=(0, 0, 1), intensity=3.0)


def _tonemap():
    from cadrays_tpu.core.tonemap import ToneMapParams

    return ToneMapParams()


def _material():
    from cadrays_tpu.core.bsdf import material

    return material(kd=(0.5, 0.2, 0.1))


def _camera():
    from cadrays_tpu.testing.scenes import cornell_camera

    return cornell_camera()


def _params():
    from cadrays_tpu.integrator.params import RenderParams

    return RenderParams(ray_depth=3, sort_rays=False)


def _progressive():
    from cadrays_tpu.integrator.progressive import ProgressiveState

    return ProgressiveState(accum=jnp.zeros((2, 2, 3)),
                            weight=jnp.zeros((2, 2)),
                            accum_sq=jnp.zeros((2, 2)), spp=jnp.int32(0),
                            fingerprint="abc")


def _adaptive():
    from cadrays_tpu.integrator.adaptive import init_adaptive

    return init_adaptive(4, 4)


def _scene():
    from cadrays_tpu.testing.scenes import cornell_box, cornell_camera

    return cornell_box().flatten(cornell_camera())


@pytest.mark.parametrize("make", [_lights, _tonemap, _material, _camera,
                                  _params, _progressive, _adaptive, _scene])
def test_package_dataclasses_round_trip(make):
    """Each pytree dataclass of the package survives flatten/unflatten,
    through jit, with its static fields intact."""
    obj = make()
    leaves, treedef = jax.tree.flatten(obj)
    back = jax.tree.unflatten(treedef, leaves)
    assert type(back) is type(obj)
    statics = [f.name for f in dataclasses.fields(obj)
               if f.metadata.get("static")]
    for name in statics:
        assert getattr(back, name) == getattr(obj, name)
    out = jax.jit(lambda t: t)(obj)
    assert jax.tree.structure(out) == treedef
    for a, b in zip(jax.tree.leaves(out), leaves):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
