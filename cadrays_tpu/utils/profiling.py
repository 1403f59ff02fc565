"""Profiling / observability.

The reference's only instrumentation is an FPS readout in the window
title and a batch-mode average (AppViewer.cxx:1248-1250, 1059-1075;
SURVEY.md §5 "tracing/profiling: minimal"). Here it is first-class
instead:

* `RayCounter` — analytic ray-query accounting for a render config (the
  integrator's issue pattern is static, so counts are exact, not
  sampled);
* `time_block` / `Timer` — wall-clock segments with device sync;
* `trace` — context manager around `jax.profiler` emitting an xplane
  trace for xprof/tensorboard;
* `render_stats` — one-call throughput summary (rays/s, spp/s, ms/frame)
  used by bench.py and the regression harness.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional

import jax


@dataclasses.dataclass
class RayCounter:
    """Exact ray-query accounting for one sample pass of the wavefront
    integrator (counts *issued* queries: masked lanes still execute)."""

    width: int
    height: int
    ray_depth: int
    n_lights: int = 0
    has_emissive: bool = False
    has_env: bool = False

    @property
    def queries_per_sample(self) -> int:
        nee = (1 if self.n_lights else 0) + int(self.has_emissive) \
            + int(self.has_env)
        return self.ray_depth * (1 + nee)

    def total(self, spp: int) -> int:
        return self.width * self.height * spp * self.queries_per_sample

    @classmethod
    def for_scene(cls, scene_data, width: int, height: int,
                  ray_depth: int) -> "RayCounter":
        return cls(
            width=width, height=height, ray_depth=ray_depth,
            n_lights=scene_data.lights.count,
            has_emissive=scene_data.emissive.count > 0,
            has_env=scene_data.envmap.enabled,
        )


class Timer:
    """Accumulating named wall-clock segments with device sync."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {tot * 1e3:9.1f} ms total "
                         f"({tot / n * 1e3:8.2f} ms x {n})")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/cadrays_xplane"):
    """jax.profiler trace for xprof/tensorboard inspection."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def render_stats(render_fn: Callable[[], object], counter: RayCounter,
                 spp: int, warmup: int = 1, reps: int = 3) -> Dict[str, float]:
    """Measure a closed render callable; returns throughput summary."""
    for _ in range(warmup):
        jax.block_until_ready(render_fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(render_fn())
        times.append(time.perf_counter() - t0)
    dt = min(times)
    total_rays = counter.total(spp)
    return {
        "seconds": dt,
        "rays_per_s": total_rays / dt,
        "spp_per_s": spp / dt,
        "ms_per_spp": dt / spp * 1e3,
        "queries_per_sample": counter.queries_per_sample,
    }
