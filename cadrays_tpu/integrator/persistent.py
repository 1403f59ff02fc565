"""Persistent wavefront: sample-staggered lane regeneration.

The fixed-depth wavefront (integrator/wavefront.render_sample) masks
retired lanes for the rest of its scan, so its average active fraction
at depth 5 is ~0.55 — nearly half of every bounce's O(R) work (sort,
shading, backward sweeps) services dead lanes. This renderer keeps the
machine full the standard wavefront way: each lane owns ONE pixel and a
per-lane quota of `spp` samples; when its path retires (miss, Russian
roulette, depth cutoff), the lane banks the sample's radiance into a
per-lane accumulator and immediately regenerates a camera ray for the
next sample id — all inside the same `lax.scan`, with the exact same
bounce physics (`render_sample`'s bounce body reads the per-lane
sid/bdepth fields, so the two paths share every shading/NEE/RR rule).

Estimator: EXACTLY `spp` samples per pixel (quota-capped, each started
sample runs to its own termination), so the mean is the same unbiased
estimator as `spp` calls to `render_sample` — only the RNG dimension
pairing differs (bounce dims are indexed by global step, not
bounce-in-sample, which keeps streams decorrelated but makes the two
paths statistically rather than bitwise equal). Lanes that finish their
quota go dead (t_max=0, sorted to the wavefront tail; traversal skips
them); `n_steps` bounds the scan, and the returned `done_cnt`
says how many samples actually completed (callers loop until the quota
is met, integrator/progressive-style, or size n_steps with slack:
average path length is ~2.7 bounces at depth 5, so
n_steps ≈ spp * 3 + depth completes ~100% on Cornell-like scenes and
~99% on glass-heavy ones — measured in
tests/test_persistent.py::test_glass_scene_completion; the sid0/done0
top-up below covers the tail exactly).

Differentiable end-to-end like render_sample (same remat policy).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from cadrays_tpu.core import rng as crng
from cadrays_tpu.core.camera import Camera
from cadrays_tpu.integrator.params import RenderParams
from cadrays_tpu.integrator.wavefront import _DIM_PIXEL, build_wavefront
from cadrays_tpu.scene.flatten import SceneData


def render_persistent(scene: SceneData, camera: Camera,
                      params: RenderParams, width: int, height: int,
                      spp: int, n_steps: int, pixel_ids=None,
                      return_stats: bool = False, sid_base=0,
                      sid0=None, done0=None):
    """Render `spp` samples per pixel with lane regeneration.

    Returns (sum_image (R, 3), done_cnt (R,)) in pixel_ids order —
    callers divide by done_cnt (== spp when n_steps has slack).
    return_stats: also return per-step live-lane counts (n_steps,).
    sid_base: first sample id (progressive accumulation passes the
    running spp so repeated calls draw fresh samples).

    Truncation note: when n_steps runs out, samples still in flight are
    DROPPED and done_cnt reports the completed count. Because a sample's
    inclusion correlates (negatively) with its own path length, the mean
    over completed samples is slightly selection-biased toward
    short-path radiance whenever done_cnt < spp. Callers that need the
    exact spp-sample estimator must TOP-UP: pass per-lane `sid0`
    (uint32, first sample id still owed — sid_base + previous done_cnt)
    and `done0` (int32, samples already completed) and the lane restarts
    the dropped sample from scratch — unbiased, since partial radiance
    is never banked. A top-up of `m` missing samples completes with a
    hard guarantee in n_steps = m * ray_depth (every sample retires
    within ray_depth bounce steps). integrator/progressive.py does this
    automatically.
    """
    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    R = pixel_ids.shape[0]
    seed = params.seed

    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)

    def camera_rays(pix, sid):
        jx, jy, ul0, ul1 = crng.sample4(pix, sid, _DIM_PIXEL, seed)
        pxx = (pix % width).astype(jnp.float32)
        pyy = (pix // width).astype(jnp.float32)
        return camera.generate_rays(pxx + jx, pyy + jy, ul0, ul1,
                                    width, height)

    sid_base = jnp.asarray(sid_base, jnp.uint32)
    sid_limit = sid_base + jnp.uint32(spp)
    state, bounce_fn = build_wavefront(scene, camera, params, width,
                                       height, sid_base, pixel_ids)
    if sid0 is not None:
        # Top-up entry: lanes resume at per-lane sample ids. Lanes whose
        # quota is already met start dead (t_max=0 → sorted to the tail).
        sid0 = jnp.asarray(sid0, jnp.uint32)
        done0 = jnp.zeros((R,), jnp.int32) if done0 is None \
            else jnp.asarray(done0, jnp.int32)
        resumed = sid0 != sid_base
        o0, d0 = camera_rays(state["pix"], sid0)
        w = resumed[..., None]
        state = dict(
            state,
            origin=jnp.where(w, o0, state["origin"]),
            direction=jnp.where(w, d0, state["direction"]),
            alive=sid0 < sid_limit,
            sid=sid0,
            done_cnt=done0,
        )

    def step(carry, t):
        st = carry
        st2, n_alive = bounce_fn(st, t)

        # ---- retire + regenerate ---------------------------------------
        died = ~st2["alive"]
        in_flight = st2["sid"] < sid_limit
        retire = died & in_flight & (st2["done_cnt"] < spp)
        # per-sample radiance clamping at banking time — identical to
        # render_sample's post-scan clamp (SettingsWidget.cxx:318-326)
        clamp = jnp.maximum(params.radiance_clamp, 1.0)
        rad = st2["radiance"]
        peak = jnp.max(rad, axis=-1, keepdims=True)
        rad = rad * jnp.where(peak > clamp,
                              clamp / jnp.maximum(peak, 1e-12), 1.0)
        done_sum = st2["done_sum"] + jnp.where(retire[..., None], rad, 0.0)
        done_cnt = st2["done_cnt"] + retire.astype(jnp.int32)

        next_sid = st2["sid"] + 1
        regen = retire & (next_sid < sid_limit)
        o_new, d_new = camera_rays(st2["pix"], next_sid)

        w = regen[..., None]
        st3 = dict(
            origin=jnp.where(w, o_new, st2["origin"]),
            direction=jnp.where(w, d_new, st2["direction"]),
            throughput=jnp.where(w, 1.0, st2["throughput"]),
            radiance=jnp.where(w, 0.0, st2["radiance"]),
            alive=st2["alive"] | regen,
            prev_pdf=jnp.where(regen, 0.0, st2["prev_pdf"]),
            prev_delta=st2["prev_delta"] | regen,
            sigma=jnp.where(w, 0.0, st2["sigma"]),
            pix=st2["pix"],
            lane=st2["lane"],
            sid=jnp.where(retire, next_sid, st2["sid"]),
            bdepth=jnp.where(regen, 0, st2["bdepth"]),
            done_sum=done_sum,
            done_cnt=done_cnt,
        )
        return st3, n_alive

    state, n_alive = jax.lax.scan(
        step, state, jnp.arange(n_steps), length=n_steps)

    # Bank any sample still in flight? No — quota samples must COMPLETE;
    # in-flight radiance at cutoff is dropped and done_cnt reports the
    # true count, keeping every counted sample unbiased.
    sum_img = jnp.zeros((R, 3), jnp.float32).at[state["lane"]].set(
        state["done_sum"])
    cnt = jnp.zeros((R,), jnp.int32).at[state["lane"]].set(
        state["done_cnt"])
    if sid0 is not None:
        # report NEW completions only (done_sum holds only new radiance)
        cnt = cnt - done0
    sum_img = jnp.nan_to_num(sum_img, nan=0.0, posinf=0.0, neginf=0.0)
    if return_stats:
        return sum_img, cnt, n_alive
    return sum_img, cnt


# ===========================================================================
# Work-pool scheduler: lanes adopt quota items across pixels
# ===========================================================================
#
# The per-lane-quota renderer above idles every lane whose own spp quota
# completes before the scan ends: lane completion time is a sum of `spp`
# iid path lengths, so its spread is ~sigma_L * sqrt(spp) steps and the
# ragged tail costs ~20% of all lane-steps at the bench config (spp=32,
# T=96 completes 86.6%).  This variant is the classic persistent-threads
# work queue rebuilt for a lockstep machine with no atomics:
#
#   * total work = R_pixels x spp samples, chopped into ITEMS of
#     `granularity` consecutive samples of one pixel; item j covers
#     pixel pixel_ids[j % R], sample ids (j // R) * g .. +g (cycling
#     pixels first keeps early items spread across the image);
#   * every lane starts on item lane_id; when a lane finishes an item it
#     pops the next one from a global pool — the "atomic counter" is a
#     per-step exclusive cumsum of the item-finished mask added to a
#     scalar pool pointer carried through the scan (deterministic, no
#     contention);
#   * completed samples bank into K fixed per-lane (pixel, sum, count)
#     SLOTS (a lane adopts a new pixel at most T/(g*mean_path) times, so
#     small K bounds it; a lane out of slots stops taking work).  The
#     slots ride the coherence-sort permutation via the wavefront's
#     `extra` state columns and are scatter-added into the image ONCE
#     after the scan — the per-step cost of migration is one cumsum.
#
# Estimator: identical per-sample physics and RNG streams as
# render_persistent (samples are keyed by (pixel, sid)); only the
# completion SET at cutoff differs, and with full completion the two
# renderers produce the same sample set exactly.

POOL_SLOTS = 4


def render_persistent_pool(scene: SceneData, camera: Camera,
                           params: RenderParams, width: int, height: int,
                           spp: int, n_steps: int, pixel_ids=None,
                           granularity: int = 16,
                           return_stats: bool = False, sid_base=0):
    """Render `spp` samples/pixel with pool-scheduled lane assignment.

    Returns (sum_image (R, 3), done_cnt (R,)) in pixel_ids order, like
    render_persistent.  Truncation at n_steps drops in-flight samples
    and leaves unpopped pool items unrendered; done_cnt reports per-pixel
    completions (callers top-up exactly like render_persistent — the
    progressive driver uses the classic renderer for the small owed
    tail).
    """
    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    R = pixel_ids.shape[0]
    K = POOL_SLOTS
    g = int(granularity)
    items_per_px = -(-spp // g)
    n_items = R * items_per_px
    seed = params.seed
    # The bank slots record the ROW (index into pixel_ids) a completed
    # item belongs to, so results never need a pixel->row inversion and
    # the final banking is a single direct scatter-add. The arange case
    # (full frames, bench chunks) additionally skips the pixel-id gather
    # at adoption time; detected on the HOST when pixel_ids is concrete.
    try:
        identity_pixels = bool(
            np.array_equal(np.asarray(pixel_ids),
                           np.arange(R, dtype=np.int32)))
    except Exception:  # traced pixel_ids (shard_map slices): gather
        identity_pixels = False

    def camera_rays(pix, sid):
        jx, jy, ul0, ul1 = crng.sample4(pix, sid, _DIM_PIXEL, seed)
        pxx = (pix % width).astype(jnp.float32)
        pyy = (pix // width).astype(jnp.float32)
        return camera.generate_rays(pxx + jx, pyy + jy, ul0, ul1,
                                    width, height)

    def item_assignment(j):
        """Pool item j -> (row, pixel, sid_lo, sid_hi). Safe for any j
        (out of range clamps; callers mask)."""
        jc = jnp.clip(j, 0, n_items - 1)
        row = (jc % R).astype(jnp.int32)
        pix = (row if identity_pixels else pixel_ids[row]) \
            .astype(jnp.int32)
        lo = (jc // R).astype(jnp.uint32) * jnp.uint32(g)
        hi = jnp.minimum(lo + jnp.uint32(g), jnp.uint32(spp))
        sb = jnp.asarray(sid_base, jnp.uint32)
        return row, pix, sb + lo, sb + hi

    state, bounce_fn = build_wavefront(scene, camera, params, width,
                                       height,
                                       jnp.asarray(sid_base, jnp.uint32),
                                       pixel_ids)
    # initial items: lane i owns item i
    row0, pix0, lo0, hi0 = item_assignment(jnp.arange(R, dtype=jnp.int32))
    o0, d0 = camera_rays(pix0, lo0)
    bc = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)
    extra0 = jnp.concatenate([
        bc(jnp.where(jnp.arange(K)[None, :] == 0, row0[:, None], -1)
           .astype(jnp.int32)),                       # bank_row (K)
        jnp.zeros((R, 3 * K), jnp.float32),           # bank_sum (K,3)
        bc(jnp.zeros((R, K), jnp.int32)),             # bank_cnt (K)
        bc(jnp.zeros((R, 1), jnp.int32)),             # cur slot
        bc(hi0[:, None].astype(jnp.int32)),           # item sid end
    ], axis=1)
    state = dict(state, origin=o0, direction=d0, pix=pix0, sid=lo0,
                 extra=extra0)

    def split_extra(e):
        i32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        return dict(
            bank_row=i32(e[:, 0:K]),
            bank_sum=e[:, K:4 * K].reshape(-1, K, 3),
            bank_cnt=i32(e[:, 4 * K:5 * K]),
            slot=i32(e[:, 5 * K]),
            item_end=i32(e[:, 5 * K + 1]),
        )

    def join_extra(d):
        return jnp.concatenate([
            bc(d["bank_row"]),
            d["bank_sum"].reshape(-1, 3 * K),
            bc(d["bank_cnt"]),
            bc(d["slot"][:, None]),
            bc(d["item_end"][:, None]),
        ], axis=1)

    clamp = jnp.maximum(params.radiance_clamp, 1.0)

    def step(carry, t):
        st, pool_ptr = carry
        st2, n_alive = bounce_fn(st, t)
        ex = split_extra(st2["extra"])
        item_end = ex["item_end"].astype(jnp.uint32)
        slot = ex["slot"]

        died = ~st2["alive"]
        in_item = st2["sid"] < item_end
        retire = died & in_item
        # bank the finished sample into the current slot (per-sample
        # clamp at banking time, same as render_persistent)
        rad = st2["radiance"]
        peak = jnp.max(rad, axis=-1, keepdims=True)
        rad = rad * jnp.where(peak > clamp,
                              clamp / jnp.maximum(peak, 1e-12), 1.0)
        onehot = jax.nn.one_hot(slot, K, dtype=jnp.float32)
        bank_sum = ex["bank_sum"] + jnp.where(
            retire[:, None, None],
            onehot[:, :, None] * rad[:, None, :], 0.0)
        bank_cnt = ex["bank_cnt"] + jnp.where(
            retire[:, None], onehot.astype(jnp.int32), 0)

        next_sid = st2["sid"] + 1
        regen_same = retire & (next_sid < item_end)
        # item finished -> pop a new one from the pool. Exclusive prefix
        # sum via a log-depth associative_scan.
        want_item = retire & (next_sid >= item_end)
        want_i32 = want_item.astype(jnp.int32)
        rank = jax.lax.associative_scan(jnp.add, want_i32) - want_i32
        j = pool_ptr + rank
        have = want_item & (j < n_items)
        new_row, new_pix, new_lo, new_hi = item_assignment(j)
        pool_ptr = pool_ptr + jnp.sum(want_item.astype(jnp.int32))

        # slot bookkeeping: adopting a new pixel advances the slot; a
        # lane out of slots refuses the item (it stays popped — counted
        # as dropped work; K is sized so this is negligible)
        new_slot = slot + 1
        slot_ok = new_slot < K
        adopt = have & slot_ok
        slot2 = jnp.where(adopt, new_slot, slot)
        bank_row = jnp.where(
            adopt[:, None] & (jnp.arange(K)[None, :] == new_slot[:, None]),
            new_row[:, None], ex["bank_row"])

        start = regen_same | adopt
        pix2 = jnp.where(adopt, new_pix, st2["pix"])
        sid2 = jnp.where(adopt, new_lo,
                         jnp.where(retire, next_sid, st2["sid"]))
        item_end2 = jnp.where(adopt, new_hi.astype(jnp.int32),
                              ex["item_end"])
        o_new, d_new = camera_rays(pix2, sid2)

        w = start[..., None]
        st3 = dict(
            origin=jnp.where(w, o_new, st2["origin"]),
            direction=jnp.where(w, d_new, st2["direction"]),
            throughput=jnp.where(w, 1.0, st2["throughput"]),
            radiance=jnp.where(w, 0.0, st2["radiance"]),
            alive=st2["alive"] | start,
            prev_pdf=jnp.where(start, 0.0, st2["prev_pdf"]),
            prev_delta=st2["prev_delta"] | start,
            sigma=jnp.where(w, 0.0, st2["sigma"]),
            pix=pix2,
            lane=st2["lane"],
            sid=sid2,
            bdepth=jnp.where(start, 0, st2["bdepth"]),
            done_sum=st2["done_sum"],
            done_cnt=st2["done_cnt"] + retire.astype(jnp.int32),
            extra=join_extra(dict(
                bank_row=bank_row, bank_sum=bank_sum, bank_cnt=bank_cnt,
                slot=slot2, item_end=item_end2)),
        )
        return (st3, pool_ptr), n_alive

    (state, _), n_alive = jax.lax.scan(
        step, (state, jnp.int32(R)), jnp.arange(n_steps), length=n_steps)

    # Final banking: ONE (R*K)-row scatter-add of the banked ROWS. Sum
    # and count share one (.., 4) operand and all K slots share one
    # index vector, one scatter instead of K. Counts stay exact as f32
    # (< 2^24).
    ex = split_extra(state["extra"])
    pk = ex["bank_row"].reshape(-1)                      # (R*K,)
    valid = pk >= 0
    rows = jnp.where(valid, pk, 0)
    payload = jnp.concatenate(
        [ex["bank_sum"].reshape(-1, 3),
         ex["bank_cnt"].reshape(-1).astype(jnp.float32)[:, None]], axis=1)
    acc = jnp.zeros((R, 4), jnp.float32).at[rows].add(
        jnp.where(valid[:, None], payload, 0.0))
    sum_img = jnp.nan_to_num(acc[:, :3], nan=0.0, posinf=0.0, neginf=0.0)
    cnt = acc[:, 3].astype(jnp.int32)
    if return_stats:
        return sum_img, cnt, n_alive
    return sum_img, cnt
