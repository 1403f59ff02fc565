"""Camera models: thin-lens perspective and orthographic.

Capability contract (reference: src/Launcher/SettingsWidget.cxx:179-236 —
perspective/ortho switch, FOVy, aperture radius, focal distance, autofocus;
src/ImportExport/ImportExport.cxx:436-499 — eye/at/up/size serialization).
Here a camera is a differentiable pytree; ray generation is pure JAX so
pixel gradients flow to every camera parameter (position, orientation,
fov, aperture, focus).
"""
from __future__ import annotations

from cadrays_tpu.utils import struct
import jax.numpy as jnp

from cadrays_tpu.core import vecmath as vm

PERSPECTIVE = 0
ORTHOGRAPHIC = 1


@struct.dataclass
class Camera:
    """Differentiable camera pytree.

    ``projection`` is static (python int) so jit specializes the ray-gen
    branch away; all float fields are traced leaves.
    """

    eye: jnp.ndarray  # (3,)
    at: jnp.ndarray  # (3,)
    up: jnp.ndarray  # (3,)
    fovy_deg: jnp.ndarray  # scalar, vertical field of view (perspective)
    aperture: jnp.ndarray  # lens radius in world units; 0 = pinhole
    focal_dist: jnp.ndarray  # focal plane distance; <=0 -> |at - eye|
    ortho_scale: jnp.ndarray  # half-height of the ortho view volume
    projection: int = struct.field(pytree_node=False, default=PERSPECTIVE)

    @classmethod
    def look_at(
        cls,
        eye=(0.0, 0.0, 5.0),
        at=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        fovy_deg=60.0,
        aperture=0.0,
        focal_dist=0.0,
        ortho_scale=1.0,
        projection=PERSPECTIVE,
    ) -> "Camera":
        # Leaves are HOST numpy: the interactive surface (console, view
        # presets, orbit/flight controls) reads camera scalars constantly,
        # and a device-resident scalar costs a device-to-host copy per
        # read. jit traces numpy leaves exactly like device ones, so the
        # render path is unchanged.
        import numpy as np

        f32 = np.float32
        return cls(
            eye=np.asarray(eye, f32),
            at=np.asarray(at, f32),
            up=np.asarray(up, f32),
            fovy_deg=f32(fovy_deg),
            aperture=f32(aperture),
            focal_dist=f32(focal_dist),
            ortho_scale=f32(ortho_scale),
            projection=int(projection),
        )

    def basis(self):
        """Right-handed view basis (right, up', forward)."""
        fwd = vm.normalize(self.at - self.eye)
        right = vm.normalize(jnp.cross(fwd, self.up))
        up = jnp.cross(right, fwd)
        return right, up, fwd

    def basis_np(self):
        """Host-side view basis (numpy, no device dispatch) for the
        interactive command surface."""
        import numpy as np

        fwd = np.asarray(self.at, np.float64) - np.asarray(self.eye,
                                                           np.float64)
        fwd /= max(np.linalg.norm(fwd), 1e-12)
        right = np.cross(fwd, np.asarray(self.up, np.float64))
        right /= max(np.linalg.norm(right), 1e-12)
        up = np.cross(right, fwd)
        return (right.astype(np.float32), up.astype(np.float32),
                fwd.astype(np.float32))

    def generate_rays(self, px, py, u_lens0, u_lens1, width, height):
        """Map film samples to world rays.

        px, py: continuous film coordinates in [0, W) x [0, H) (jitter
        already added); u_lens*: uniforms for aperture sampling.
        Returns (origin, direction) with direction normalized.
        Film y grows downward (row 0 = top), matching image layout.
        """
        right, up, fwd = self.basis()
        aspect = jnp.float32(width / height)
        # NDC in [-1, 1], y up.
        sx = 2.0 * (px + 0.0) / width - 1.0
        sy = 1.0 - 2.0 * (py + 0.0) / height
        sx = sx[..., None]
        sy = sy[..., None]

        if self.projection == ORTHOGRAPHIC:
            half_h = self.ortho_scale
            origin = self.eye + right * (sx * half_h * aspect) + up * (sy * half_h)
            direction = jnp.broadcast_to(fwd, origin.shape)
            return origin, direction

        tan_half = jnp.tan(jnp.deg2rad(self.fovy_deg) * 0.5)
        d = vm.normalize(
            fwd + right * (sx * tan_half * aspect) + up * (sy * tan_half)
        )
        origin = jnp.broadcast_to(self.eye, d.shape)

        # Thin-lens depth of field: jitter origin on the aperture disk and
        # re-aim at the focal-plane point (SettingsWidget.cxx:217-229 knobs).
        focal = jnp.where(
            self.focal_dist > 0.0, self.focal_dist, vm.length(self.at - self.eye)
        )
        # Concentric-ish disk sample (polar is fine for a lens).
        # max() keeps sqrt's gradient finite at u=0 — otherwise the
        # unselected-branch inf turns the whole camera VJP into NaN.
        r = jnp.sqrt(jnp.maximum(u_lens0, 1e-12))[..., None] * self.aperture
        phi = (2.0 * jnp.pi) * u_lens1[..., None]
        lens_off = right * (r * jnp.cos(phi)) + up * (r * jnp.sin(phi))
        # Focal point along the *axial* distance (plane at depth `focal`).
        ct = jnp.maximum(vm.dot(d, fwd, keepdims=True), 1e-6)
        p_focus = origin + d * (focal / ct)
        origin_dof = origin + lens_off
        dir_dof = vm.normalize(p_focus - origin_dof)
        use_dof = self.aperture > 0.0
        origin = jnp.where(use_dof, origin_dof, origin)
        direction = jnp.where(use_dof, dir_dof, d)
        return origin, direction
