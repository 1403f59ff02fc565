"""Batch renderer CLI — the reference's headless mode.

`CADRays.exe <script.tcl> [maxFrames]` runs the script, renders exactly N
progressive frames, dumps `Output_<name>_<N>.png` and the average FPS to
a .txt (main.cxx:164-229, AppViewer.cxx:1059-1075, 1255-1264). Native
equivalent:

    python -m cadrays_tpu.cli.render scene.crt --spp 100 [--out img.png]
        [--hdr out.hdr] [--res W H] [--fps-file out.txt]

Used by the golden-image/perf harness (tests/ + tools/regression.py).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("script", help="scene script (.crt) to execute")
    ap.add_argument("--spp", type=int, default=100,
                    help="progressive samples to accumulate (maxFrames)")
    ap.add_argument("--out", default=None, help="LDR output png path")
    ap.add_argument("--hdr", default=None, help="HDR output path (.hdr/.pfm)")
    ap.add_argument("--res", type=int, nargs=2, default=None)
    ap.add_argument("--fps-file", default=None)
    ap.add_argument("--step", type=int, default=None,
                    help="samples per progressive step (default: all at once)")
    ap.add_argument("--log", default=None,
                    help="append structured JSONL events to this file")
    args = ap.parse_args(argv)
    from cadrays_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    import numpy as np

    from cadrays_tpu.cli.commands import Session, make_console
    from cadrays_tpu.core.tonemap import apply_tonemap, linear_to_srgb
    from cadrays_tpu.integrator.progressive import progressive_step
    from cadrays_tpu.utils.image import save_image

    from cadrays_tpu.utils.log import configure, get_logger

    configure(path=args.log, human=False)
    log = get_logger("render")
    session = Session()
    session.cwd = os.path.dirname(os.path.abspath(args.script)) or "."
    console = make_console(session)
    log.info("scene.load", script=args.script)
    console.source(args.script)
    if args.res:
        session.width, session.height = args.res

    data = session.scene.flatten(session.camera)
    step = args.step or args.spp
    state = session.progressive

    t0 = time.perf_counter()
    done = 0
    import jax

    while done < args.spp:
        n = min(step, args.spp - done)
        state = progressive_step(data, session.camera, session.params,
                                 session.width, session.height, state,
                                 samples_per_step=n)
        done += n
    jax.block_until_ready(state.accum)
    dt = time.perf_counter() - t0
    session.progressive = state

    name = os.path.splitext(os.path.basename(args.script))[0]
    out = args.out or f"Output_{name}_{args.spp}.png"
    hdr = np.asarray(state.image)
    ldr = np.asarray(linear_to_srgb(apply_tonemap(hdr,
                                                  session.params.tonemap)))
    save_image(out, ldr)
    if args.hdr:
        save_image(args.hdr, hdr)

    fps = args.spp / dt if dt > 0 else 0.0
    log.info("render.done", scene=name, spp=args.spp,
             seconds=round(dt, 3), spp_per_s=round(fps, 3), out=out)
    line = json.dumps({"scene": name, "spp": args.spp,
                       "res": [session.width, session.height],
                       "seconds": round(dt, 3),
                       "spp_per_s": round(fps, 3)})
    print(line)
    if args.fps_file:
        with open(args.fps_file, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
