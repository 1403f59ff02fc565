"""Elastic rendering: coordinator init with retry + checkpointed resume.

The reference is a desktop tool with no failure story beyond
name-collision repair (SURVEY.md §5); a multi-host renderer needs
one. The standard JAX recipe is implemented here:

* `init_distributed` wraps `jax.distributed.initialize` with bounded
  retries, so a restarted worker re-joins the coordinator instead of
  dying on the first connection refusal (preemption recovery);
* `render_with_recovery` runs the progressive loop with periodic
  accumulator checkpoints (integrator/progressive.save_state — the
  accumulator is a plain sharded array) and, on a step failure, reloads
  the last checkpoint and continues. Because the RNG is counter-based
  (core/rng.py), a resumed run is bit-identical to an uninterrupted one
  at equal spp — the property the recovery test asserts.

The driver-level contract: a preempted host restarts the SAME command;
`init_distributed` re-joins, `render_with_recovery` finds the
checkpoint, and the render continues from the last saved sample count.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

from cadrays_tpu.utils.log import get_logger

log = get_logger("elastic")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     retries: int = 12, backoff_s: float = 5.0) -> None:
    """`jax.distributed.initialize` with retry — preempted workers
    reconnect instead of crashing. No-op for single-process runs."""
    if coordinator_address is None and num_processes is None:
        return
    import jax

    last = None
    for attempt in range(retries):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
            log.info("coordinator.joined", attempt=attempt)
            return
        except Exception as e:  # pragma: no cover - needs real cluster
            last = e
            log.warning("coordinator.retry", attempt=attempt, error=str(e))
            time.sleep(backoff_s)
    raise RuntimeError(f"could not join coordinator: {last}")


def render_with_recovery(data, camera, params, width: int, height: int,
                         spp: int, checkpoint_path: str,
                         checkpoint_every: int = 8,
                         samples_per_step: int = 1,
                         step_fn: Optional[Callable] = None,
                         max_failures: int = 3):
    """Accumulate `spp` samples with checkpointed resume.

    Returns the final ProgressiveState. A crashed/preempted run invoked
    again with the same arguments resumes from `checkpoint_path`.
    `step_fn` defaults to integrator.progressive.progressive_step (tests
    inject a failing wrapper).
    """
    import jax

    from cadrays_tpu.integrator.progressive import (load_state,
                                                    progressive_step,
                                                    save_state)

    step = step_fn or progressive_step
    state = None
    if os.path.exists(checkpoint_path):
        try:
            state = load_state(checkpoint_path)
            log.info("resume", path=checkpoint_path,
                     spp=int(state.spp))
        except Exception as e:
            log.warning("checkpoint.unreadable", path=checkpoint_path,
                        error=str(e))
            state = None

    failures = 0
    # Samples accumulated since the last checkpoint write — NOT a modulo
    # on absolute spp, which never fires when samples_per_step does not
    # divide checkpoint_every (a crash would then restart from zero).
    done_since_save = 0
    while state is None or int(state.spp) < spp:
        done = 0 if state is None else int(state.spp)
        n = min(samples_per_step, spp - done)
        try:
            state = step(data, camera, params, width, height, state, n)
            jax.block_until_ready(state.accum)
        except Exception as e:
            failures += 1
            log.error("step.failed", at_spp=done, failures=failures,
                      error=str(e))
            if failures > max_failures:
                raise
            # reload the last good accumulator and retry the step
            state = (load_state(checkpoint_path)
                     if os.path.exists(checkpoint_path) else None)
            continue
        done_since_save += n
        if done_since_save >= checkpoint_every or int(state.spp) >= spp:
            save_state(state, checkpoint_path)
            log.debug("checkpoint", spp=int(state.spp))
            done_since_save = 0
    return state
