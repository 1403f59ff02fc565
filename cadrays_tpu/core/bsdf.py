"""Double-layered BSDF: coat over {diffuse, glossy, transmission} base.

Capability contract (reference MaterialEditor.cxx:639-1099 presets and lobe
editors; ImportExport.cxx:155-231 full lobe serialization): lobes
Kc (coat, + coatRoughness + coat Fresnel), Kd (diffuse), Ks (glossy,
+ baseRoughness + base Fresnel), Kt (transmission), Le (emission),
Absorption (rgb + coeff, Beer-Lambert), with the energy-normalization rule
max_channel(Kd + Ks + Kt) <= 1 (MaterialEditor.cxx:311-329).

Array design: materials are a struct-of-arrays pytree; eval/sample are
branchless over a gathered wavefront (every lobe evaluated, blended by
probability masks) so mixed-material batches run as one vectorized op.
Delta lobes (roughness below DELTA_ROUGHNESS, and smooth transmission) are
excluded from eval/pdf and flagged on sample for MIS correctness.

Model:
* coat: GGX reflection lobe, tint Kc, Fresnel Fc(cos), roughness=coatRoughness.
  Energy passing into the base is attenuated by (1 - Kc*Fc) per channel,
  view- and light-direction dependent.
* base diffuse: Lambert Kd/pi under the coat.
* base glossy: GGX reflection, tint Ks * Fb(cos_h), roughness=baseRoughness.
* base transmission: smooth dielectric interface (delta): Fresnel split
  between an untinted reflection and a Kt-tinted refraction with
  eta from the base Fresnel when Dielectric, else 1.5; Beer-Lambert
  absorption exp(-coeff*(1-color)*dist) inside the medium.
"""
from __future__ import annotations

from cadrays_tpu.utils import struct
import jax
import jax.numpy as jnp
import numpy as np

from cadrays_tpu.core import sampling as smp
from cadrays_tpu.core import vecmath as vm
from cadrays_tpu.core.fresnel import (
    FRESNEL_CONSTANT,
    FRESNEL_DIELECTRIC,
    FRESNEL_SCHLICK,
    dielectric_reflectance,
    eval_fresnel,
)

DELTA_ROUGHNESS = 1e-3
DEFAULT_IOR = 1.5

# Lobe ids (for sampling bookkeeping)
LOBE_COAT = 0
LOBE_DIFFUSE = 1
LOBE_GLOSSY = 2
LOBE_TRANSMISSION = 3
LOBE_NONE = 4


@struct.dataclass
class Material:
    """Struct-of-arrays material table: every field has leading dims (M, ...).

    The same class represents a per-ray *gathered* wavefront of materials
    (leading dim = number of rays) — all math broadcasts.
    """

    kc: jnp.ndarray  # (M, 3) coat reflection color
    kd: jnp.ndarray  # (M, 3) diffuse color
    ks: jnp.ndarray  # (M, 3) glossy color
    kt: jnp.ndarray  # (M, 3) transmission color
    le: jnp.ndarray  # (M, 3) emission radiance
    base_rough: jnp.ndarray  # (M,)
    coat_rough: jnp.ndarray  # (M,)
    absorp_color: jnp.ndarray  # (M, 3)
    absorp_coeff: jnp.ndarray  # (M,)
    base_ftype: jnp.ndarray  # (M,) int32
    base_fparams: jnp.ndarray  # (M, 4)
    coat_ftype: jnp.ndarray  # (M,) int32
    coat_fparams: jnp.ndarray  # (M, 4)
    tex_id: jnp.ndarray  # (M,) int32, -1 = no texture (Kd map)
    ks_tex_id: jnp.ndarray  # (M,) int32, -1 = no texture (Ks map)
    uv_scale: jnp.ndarray  # (M,)

    def gather(self, idx: jnp.ndarray) -> "Material":
        """Gather per-ray materials by index array."""
        import jax

        return jax.tree.map(lambda a: a[idx], self)

    @property
    def eta(self) -> jnp.ndarray:
        """Refraction IOR: from the base Fresnel when Dielectric, else 1.5."""
        return jnp.where(
            self.base_ftype == FRESNEL_DIELECTRIC,
            jnp.maximum(self.base_fparams[..., 0], 1.0 + 1e-3),
            DEFAULT_IOR,
        )


def material(
    kd=(0.8, 0.8, 0.8),
    ks=(0.0, 0.0, 0.0),
    kt=(0.0, 0.0, 0.0),
    kc=(0.0, 0.0, 0.0),
    le=(0.0, 0.0, 0.0),
    base_rough=0.0,
    coat_rough=0.0,
    absorp_color=(0.0, 0.0, 0.0),
    absorp_coeff=0.0,
    base_fresnel=(FRESNEL_SCHLICK, np.array([0.04, 0.04, 0.04, 0.0], np.float32)),
    coat_fresnel=(FRESNEL_DIELECTRIC, np.array([1.5, 0.0, 0.0, 0.0], np.float32)),
    tex_id=-1,
    ks_tex_id=-1,
    uv_scale=1.0,
) -> Material:
    """Host-side single-material constructor (leading dim 1)."""

    def v3(x):
        a = np.asarray(x, np.float32)
        if a.ndim == 0:
            a = np.full(3, float(a), np.float32)
        return a.reshape(1, 3)

    def f4(fr):
        t, p = fr
        return np.int32([t]), np.asarray(p, np.float32).reshape(1, 4)

    bt, bp = f4(base_fresnel)
    ct, cp = f4(coat_fresnel)
    return Material(
        kc=v3(kc),
        kd=v3(kd),
        ks=v3(ks),
        kt=v3(kt),
        le=v3(le),
        base_rough=np.float32([base_rough]),
        coat_rough=np.float32([coat_rough]),
        absorp_color=v3(absorp_color),
        absorp_coeff=np.float32([absorp_coeff]),
        base_ftype=bt,
        base_fparams=bp,
        coat_ftype=ct,
        coat_fparams=cp,
        tex_id=np.int32([tex_id]),
        ks_tex_id=np.int32([ks_tex_id]),
        uv_scale=np.float32([uv_scale]),
    )


def concat_materials(mats) -> Material:
    """Stack a list of single materials into one table."""
    import jax

    return jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *mats)


def normalize_energy(m: Material) -> Material:
    """Enforce max_channel(Kd + Ks + Kt) <= 1 by uniform rescale of the
    three base lobes — the reference's normalization semantics
    (MaterialEditor.cxx:311-329)."""
    total = m.kd + m.ks + m.kt
    peak = jnp.max(total, axis=-1, keepdims=True)
    scale = jnp.where(peak > 1.0, 1.0 / jnp.maximum(peak, 1e-8), 1.0)
    return m.replace(kd=m.kd * scale, ks=m.ks * scale, kt=m.kt * scale)


# ---------------------------------------------------------------------------
# Lobe machinery (wavefront: every arg has leading ray dims)
# ---------------------------------------------------------------------------

def _alpha(rough):
    return jnp.maximum(rough * rough, 1e-6)


def _coat_through(m: Material, cos_t):
    """Per-channel energy passing through the coat at angle cos_t."""
    fc = eval_fresnel(m.coat_ftype, m.coat_fparams, cos_t)
    return jnp.clip(1.0 - m.kc * fc, 0.0, 1.0)


def _lobe_weights(m: Material, cos_o):
    """Approximate per-lobe albedos at the view angle -> sampling probs."""
    fc = eval_fresnel(m.coat_ftype, m.coat_fparams, cos_o)
    coat_refl = jnp.clip(m.kc * fc, 0.0, 1.0)
    through = jnp.clip(1.0 - coat_refl, 0.0, 1.0)
    fb = eval_fresnel(m.base_ftype, m.base_fparams, cos_o)
    w_c = vm.luminance(coat_refl)
    w_d = vm.luminance(through * m.kd)
    w_s = vm.luminance(through * m.ks * fb)
    w_t = vm.luminance(through * m.kt)
    return w_c, w_d, w_s, w_t


def eval_bsdf(m: Material, wo, wi, n):
    """Evaluate the *smooth* (non-delta) lobes and their sampling pdf.

    wo: direction to viewer; wi: direction to light; n: shading normal
    facing wo. Returns (f_rgb, pdf) — both zero for directions below the
    hemisphere. Used by NEE and MIS. Transmission is always delta and
    never appears here.
    """
    cos_o = jnp.clip(vm.dot(wo, n), 1e-6, 1.0)
    cos_i = vm.dot(wi, n)
    valid = cos_i > 1e-6
    cos_i = jnp.clip(cos_i, 1e-6, 1.0)

    h = vm.normalize(wo + wi)
    cos_h = jnp.clip(vm.dot(h, n), 0.0, 1.0)
    cos_oh = jnp.clip(vm.dot(wo, h), 1e-6, 1.0)

    co = cos_o[..., None]
    ci = cos_i[..., None]

    # Coat GGX lobe (smooth only if coat_rough above delta threshold).
    a_c = _alpha(m.coat_rough)
    fc_h = eval_fresnel(m.coat_ftype, m.coat_fparams, cos_oh)
    d_c = smp.ggx_d(cos_h, a_c)
    g_c = smp.ggx_g2(cos_o, cos_i, a_c)
    f_coat = m.kc * fc_h * (d_c * g_c / (4.0 * cos_o * cos_i))[..., None]
    coat_smooth = m.coat_rough > DELTA_ROUGHNESS
    coat_active = coat_smooth & (vm.luminance(m.kc) > 0.0)
    f_coat = jnp.where(coat_active[..., None], f_coat, 0.0)

    through_o = _coat_through(m, cos_o)
    through_i = _coat_through(m, cos_i)
    through = through_o * through_i

    # Diffuse lobe under the coat.
    f_diff = through * m.kd * smp.INV_PI

    # Glossy base lobe.
    a_s = _alpha(m.base_rough)
    fb_h = eval_fresnel(m.base_ftype, m.base_fparams, cos_oh)
    d_s = smp.ggx_d(cos_h, a_s)
    g_s = smp.ggx_g2(cos_o, cos_i, a_s)
    f_spec = through_o * m.ks * fb_h * (d_s * g_s / (4.0 * cos_o * cos_i))[..., None]
    spec_smooth = m.base_rough > DELTA_ROUGHNESS
    spec_active = spec_smooth & (vm.luminance(m.ks) > 0.0)
    f_spec = jnp.where(spec_active[..., None], f_spec, 0.0)

    f = f_coat + f_diff + f_spec

    # pdf matching `sample_bsdf`'s lobe selection. The denominator is the
    # FULL weight sum over all lobes (delta ones included) — exactly the
    # normalizer sample_bsdf divides by when picking a lobe — so the
    # marginal density of a smooth direction is sum_{smooth L} p_L pdf_L.
    # Only the numerator is restricted to smooth lobes (delta lobes have
    # zero density at any given direction).
    w_c, w_d, w_s, w_t = _lobe_weights(m, cos_o)
    w_sum = jnp.maximum(w_c + w_d + w_s + w_t, 1e-8)
    w_c_smooth = jnp.where(coat_active, w_c, 0.0)
    w_s_smooth = jnp.where(spec_active, w_s, 0.0)

    pdf_cos = smp.cosine_hemisphere_pdf(cos_i)
    pdf_c = smp.ggx_reflect_pdf(wo, wi, n, a_c)
    pdf_s = smp.ggx_reflect_pdf(wo, wi, n, a_s)
    pdf = (w_c_smooth * pdf_c + w_d * pdf_cos + w_s_smooth * pdf_s) / w_sum

    f = jnp.where(valid[..., None], f, 0.0)
    pdf = jnp.where(valid, pdf, 0.0)
    return f, pdf


def dielectric_split(eta_mat, wo, n, front):
    """Fresnel reflect/refract split at a smooth dielectric interface.

    eta_mat: material IOR (>1, the dense side); n faces the viewer (wo);
    front: True when entering the dense medium (air->glass), False when
    exiting. Returns (f_refl, wi_refr, tir): unpolarized reflectance,
    refracted direction (garbage under TIR — mask with tir), TIR mask.
    Exit-side Fresnel uses reciprocity: F is evaluated at the sparse-side
    angle, with TIR forcing full reflection.
    """
    eta_rel = jnp.where(front, 1.0 / eta_mat, eta_mat)  # n_i / n_t
    wi_refr, tir = vm.refract(-wo, n, eta_rel)
    cos_o = jnp.clip(vm.dot(wo, n), 1e-6, 1.0)
    cos_t = jnp.abs(vm.dot(wi_refr, n))
    cos_sparse = jnp.where(front, cos_o, cos_t)
    f = dielectric_reflectance(eta_mat, cos_sparse)
    f = jnp.where(tir, 1.0, f)
    return f, wi_refr, tir


def sample_bsdf(m: Material, wo, n, u, front=None):
    """Sample an outgoing direction from the layered BSDF.

    front: optional (...,) bool — True when the hit is on the front face
    (entering the medium on refraction). Defaults to True (legacy callers
    without face information; refraction then always uses 1/eta).

    u: (..., 4) uniforms. Returns a dict with:
      wi           (..., 3) sampled direction
      weight       (..., 3) f * cos / pdf (throughput multiplier)
      pdf          (...,)   solid-angle pdf of smooth lobes (0 for delta)
      is_delta     (...,)   bool — sampled a delta lobe (skip MIS next hit)
      transmitted  (...,)   bool — crossed the surface (medium change)
      valid        (...,)   bool — sample usable (else kill path)
    """
    cos_o = jnp.clip(vm.dot(wo, n), 1e-6, 1.0)

    w_c, w_d, w_s, w_t = _lobe_weights(m, cos_o)
    w_sum = w_c + w_d + w_s + w_t
    alive = w_sum > 1e-7
    w_sum = jnp.maximum(w_sum, 1e-8)
    p_c = w_c / w_sum
    p_d = w_d / w_sum
    p_s = w_s / w_sum
    # p_t is the remainder.

    sel = u[..., 0]
    pick_c = sel < p_c
    pick_d = (~pick_c) & (sel < p_c + p_d)
    pick_s = (~pick_c) & (~pick_d) & (sel < p_c + p_d + p_s)
    pick_t = (~pick_c) & (~pick_d) & (~pick_s)

    u1, u2 = u[..., 1], u[..., 2]

    # --- candidate directions -------------------------------------------
    # coat / glossy: GGX half-vector reflect
    a_c = _alpha(m.coat_rough)
    a_s = _alpha(m.base_rough)
    alpha_sel = jnp.where(pick_c, a_c, a_s)
    h_local = smp.ggx_sample_h(u1, u2, alpha_sel)
    h = vm.to_world(h_local, n)
    wi_refl = vm.normalize(vm.reflect(-wo, h))

    # diffuse: cosine hemisphere
    wi_diff = vm.to_world(smp.cosine_hemisphere(u1, u2), n)

    # transmission: smooth dielectric split on the material IOR, aware of
    # the medium side (entering vs exiting) when `front` is supplied
    eta_mat = m.eta
    if front is None:
        front = jnp.ones(cos_o.shape, bool)
    f_t, wi_refr, tir = dielectric_split(eta_mat, wo, n, front)
    refl_t = u[..., 3] < f_t
    wi_mirror = vm.normalize(vm.reflect(-wo, n))
    wi_refr = vm.normalize(wi_refr)
    do_refract = (~refl_t) & (~tir)
    wi_trans = jnp.where(do_refract[..., None], wi_refr, wi_mirror)

    wi = jnp.where(
        pick_d[..., None],
        wi_diff,
        jnp.where(pick_t[..., None], wi_trans, wi_refl),
    )
    # Detached sampling: the sampled direction is treated as a constant of
    # the estimator — gradients flow through eval/weights only. This is
    # the standard unbiased construction for material/light/camera
    # parameter gradients and keeps warp-jacobian NaNs out of the VJP.
    wi = jax.lax.stop_gradient(wi)

    cos_i_signed = vm.dot(wi, n)
    transmitted = pick_t & do_refract
    reflected_ok = cos_i_signed > 1e-6

    # --- weights ---------------------------------------------------------
    coat_delta = m.coat_rough <= DELTA_ROUGHNESS
    spec_delta = m.base_rough <= DELTA_ROUGHNESS
    is_delta = (
        (pick_c & coat_delta) | (pick_s & spec_delta) | pick_t
    )

    # Detached measure: every division by a sampling density treats that
    # density as a constant (stop_gradient) — differentiating 1/pdf(theta)
    # would bias parameter gradients (the pdf is part of the Monte Carlo
    # measure, not of the integrand).
    sg = jax.lax.stop_gradient

    # Smooth-lobe path: single eval of the full smooth BSDF + its pdf for
    # the chosen direction -> unbiased one-sample MIS over lobes.
    f_smooth, pdf_smooth = eval_bsdf(m, wo, wi, n)
    pdf_det = sg(pdf_smooth)
    cos_i = jnp.clip(cos_i_signed, 0.0, 1.0)
    w_smooth = f_smooth * (cos_i / jnp.maximum(pdf_det, 1e-8))[..., None]
    w_smooth = jnp.where((pdf_det > 1e-10)[..., None], w_smooth, 0.0)

    # Delta coat reflection: weight = Kc*Fc / p_lobe (cos/pdf cancel).
    fc_o = eval_fresnel(m.coat_ftype, m.coat_fparams, cos_o)
    w_coat_delta = m.kc * fc_o / jnp.maximum(sg(p_c), 1e-8)[..., None]

    # Delta glossy reflection: Ks*Fb under the coat.
    fb_o = eval_fresnel(m.base_ftype, m.base_fparams, cos_o)
    through_o = _coat_through(m, cos_o)
    w_spec_delta = through_o * m.ks * fb_o \
        / jnp.maximum(sg(p_s), 1e-8)[..., None]

    # Transmission: Fresnel split already importance-sampled -> weight is
    # the tint alone (refraction) or white (reflection), under the coat.
    p_t = jnp.maximum(sg(1.0 - p_c - p_d - p_s), 1e-8)
    w_refr = through_o * m.kt / p_t[..., None]
    w_mirror = through_o * jnp.ones_like(m.kt) / p_t[..., None]
    w_trans = jnp.where(do_refract[..., None], w_refr, w_mirror)

    weight = w_smooth
    weight = jnp.where((pick_c & coat_delta)[..., None], w_coat_delta, weight)
    weight = jnp.where((pick_s & spec_delta)[..., None], w_spec_delta, weight)
    weight = jnp.where(pick_t[..., None], w_trans, weight)

    pdf = jnp.where(is_delta, 0.0, pdf_smooth)

    valid = alive & (transmitted | reflected_ok)
    weight = jnp.where(valid[..., None], weight, 0.0)

    return {
        "wi": wi,
        "weight": weight,
        "pdf": pdf,
        "is_delta": is_delta,
        "transmitted": transmitted,
        "valid": valid,
    }


def absorption_sigma(m: Material) -> jnp.ndarray:
    """Beer-Lambert extinction: sigma = coeff * (1 - color)."""
    return m.absorp_coeff[..., None] * jnp.clip(1.0 - m.absorp_color, 0.0, None)
