"""Interactive console REPL (AppConsole analogue, AppConsole.cxx:211-259).

    python -m cadrays_tpu.cli.console [startup.crt]

History, `help`, and every command from cli/commands.py. Errors are
reported inline with an `[error]` prefix (the reference color-codes these
lines, AppConsole.cxx:154-170).
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    from cadrays_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    from cadrays_tpu.cli.commands import (CommandError, Session,
                                           make_console)
    from cadrays_tpu.version import __version__

    session = Session()
    console = make_console(session)
    print(f"cadrays_tpu {__version__} console — 'help' lists commands, "
          "ctrl-D exits")
    import jax

    print(f"backend: {jax.default_backend()} "
          f"({len(jax.devices())} device(s))")

    for script in argv:
        try:
            out = console.source(script)
            if out:
                print(out)
        except (CommandError, OSError) as e:
            print(f"[error] {e}")

    while True:
        try:
            line = input("cadrays> ")
        except EOFError:
            print()
            return 0
        except KeyboardInterrupt:
            print()
            continue
        if line.strip() in ("exit", "quit"):
            return 0
        try:
            out = console.exec(line)
            if out:
                print(out)
        except CommandError as e:
            print(f"[error] {e}")
        except Exception as e:  # keep the REPL alive on internal errors
            print(f"[error] {type(e).__name__}: {e}")


if __name__ == "__main__":
    sys.exit(main())
