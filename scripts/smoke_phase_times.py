#!/usr/bin/env python3
"""Seconds per phase of ``chip_smoke.py``, for one or more checkouts.

Runs ``python3 chip_smoke.py`` from each checkout directory given, one
after the other (so that two commits are compared on the same card in
one call), stamps each line of its standard output with the time it
arrived, and gives each phase the seconds from the previous line that
names a phase ("phase N ...") to its own last such line: chip_smoke
prints a phase's lines as the phase ends. The seconds before the first
such line go to phase 1 (start-up), those after the last to "end" (the
kernel line and the last line). Writes each run's stamped output and
standard error to ``--out-dir``, prints a table (one column per run) and
one JSON line, and exits 0 only when every run did.

    python3 scripts/smoke_phase_times.py build/change build/parent \\
        --out-dir build/phase_times
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

PHASE = re.compile(r"^phase (\d+)")


def phase_seconds(stamped) -> dict:
    """Seconds per phase from ``stamped``: (seconds since the start, line)
    pairs in order; see the module docstring."""
    sec: dict = defaultdict(float)
    last = 0.0
    for t, line in stamped:
        m = PHASE.match(line)
        if m:
            sec[m.group(1)] += t - last
            last = t
    if stamped:
        sec["end"] += stamped[-1][0] - last
    return dict(sec)


def run_one(checkout: Path, out_dir: Path, label: str,
            timeout: float) -> dict:
    """chip_smoke.py from ``checkout``: its stamped lines, rc and seconds."""
    out_dir.mkdir(parents=True, exist_ok=True)
    err = open(out_dir / f"{label}.err", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                            cwd=checkout, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    stamped = []
    with open(out_dir / f"{label}.log", "w") as log:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            stamped.append((t, line.rstrip("\n")))
            log.write(f"{t:9.2f} {line}")
            log.flush()
    rc = proc.wait()
    watchdog.cancel()
    err.close()
    total = time.perf_counter() - t0
    last = stamped[-1][1] if stamped else ""
    ok = rc == 0 and last.startswith('{"ok": true')
    return dict(checkout=str(checkout), rc=rc, ok=ok, total_s=total,
                phases_s=phase_seconds(stamped))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkouts", nargs="+", type=Path)
    p.add_argument("--out-dir", type=Path, default=Path("build/phase_times"))
    p.add_argument("--timeout", type=float, default=1200.0,
                   help="seconds each run may take (default %(default)s)")
    args = p.parse_args(argv)
    runs = []
    for i, c in enumerate(args.checkouts):
        runs.append(run_one(c, args.out_dir, f"run{i}_{c.name}",
                            args.timeout))
        r = runs[-1]
        print(f"{c}: rc {r['rc']}, ok {r['ok']}, {r['total_s']:.1f} s",
              flush=True)
    keys = sorted({k for r in runs for k in r["phases_s"]},
                  key=lambda k: (not k.isdigit(), int(k) if k.isdigit()
                                 else 0))
    print("phase " + "".join(f"{r['checkout']:>24s}" for r in runs))
    for k in keys:
        print(f"{k:>5s} " + "".join(f"{r['phases_s'].get(k, 0.0):24.1f}"
                                    for r in runs))
    print("total " + "".join(f"{r['total_s']:24.1f}" for r in runs))
    print(json.dumps(runs))
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
