"""Debug-level logging, the rebuild of the reference's dbg_lvl printf system.

The reference threads a global ``dbg_lvl`` and rank id ``iam`` through every
function (reference: src/globals.h:6-7) and prints enter/exit lines at
dbg_lvl > 1 and value dumps at dbg_lvl >= 1 (e.g. src/matrix.c:171-174).
Here that becomes a module-level verbosity with structured, timed phase
logging; the per-phase wall-clock timers are the observability upgrade the
reference lacked (its only perf stats came from SuperLU's PStatPrint,
src/solve_ABglobal.c:351-360).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

from .profiling import span

# NK_DBG seeds the level for entry points that don't take a -D flag
# (bench.py, library use); set_dbg_lvl (the -D flag) overrides it.
_dbg_lvl = int(os.environ.get("NK_DBG", "0") or 0)


def set_dbg_lvl(lvl: int) -> None:
    """Set the verbosity (the -D flag). NK_DBG acts as a floor so a
    library entry point that resets to its default 0 (run_gen_a inside
    bench.py, say) doesn't silence an env-requested trace."""
    global _dbg_lvl
    _dbg_lvl = max(int(lvl), int(os.environ.get("NK_DBG", "0") or 0))


def get_dbg_lvl() -> int:
    return _dbg_lvl


def dbg(lvl: int, msg: str) -> None:
    """Print msg if the current debug level is >= lvl."""
    if _dbg_lvl >= lvl:
        print(f"(0) {msg}", flush=True)


@contextlib.contextmanager
def timed(name: str, lvl: int = 1):
    """Time a phase; at dbg level >= lvl report its wall-clock on exit.
    The phase is a ``profiling.span`` of its name too."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        if _dbg_lvl >= lvl:
            print(f"(0) {name}: {time.perf_counter() - t0:.3f}s", file=sys.stderr, flush=True)
