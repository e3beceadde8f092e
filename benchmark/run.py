#!/usr/bin/env python3
"""The benchmark of the PyTorch port (``nk_ocn_tracer_jacobian_precond_tpu_torch``):
one cell of ``BENCHMARK.json`` for ``--seconds`` on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``benchmark/configs/<name>.json``: the grid,
the assembly options, the leaf size, the factor precision, the solve
tolerance and the limits of the check) and a traffic mix
(``benchmark/traffic/<name>.json``), whose ``values`` say how a step's
Jacobian values are drawn: ``nonzeros`` (the default: each nonzero of the
configuration's CSR times 1 + ``value_perturbation`` z, handed to the
program on the host) or ``fields`` (each entry of stage 1's coefficient
fields times 1 + ``field_perturbation`` z, re-assembled on the card by the
port's own update plan: ``FieldUpdate``). Every metric is read by its own
file, ``benchmark/metrics/<name>.py`` (``read(run) -> float | None``). Adding a
configuration, a mix or a metric adds files and entries; nothing here
names one.

The run: the configuration's matrix (built once by the frozen stage 1 of
``benchmark/reference`` and cached under ``build/benchmark/``), symbolic
analysis, the cold factor and the mix's warm-up steps are set-up; then a
closed loop of steps while fewer than ``--seconds`` have passed. A step
hands the facade (``solver/mf.py::MultifrontalFactorization``) new values
on the frozen pattern and refactors, when the mix says so, then solves
the step's right-hand sides. With ``--trace 1`` more steps follow the
window: the mix's ``traced_steps`` under torch.profiler, then, where the
mix refactors, one under the engine's stage timer.
Then the last factors are applied once without refinement, the program is
freed, and the reference judges every step's solutions (``correct``). The
last line of stdout is one JSON object; the numbers compared, with their
limits, are the last lines of stderr and the line's last key.

The process's host threads are fixed (``HOST_THREADS`` for torch, one for
the BLAS and OpenMP pools). The log gives the card's clocks and power
before the warm-up and after the window, and the process's CPU time over
the window.

Without a CUDA card, or with fewer than the cell asks for, the run exits
with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CACHE = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "nk_ocn_tracer_jacobian_precond_tpu")
# where the program and the libraries it loads keep their build and kernel
# caches: fixed directories inside the checkout
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda_cache"}
# the program's host threads: torch's intra-op pool; the BLAS and OpenMP
# pools run one thread (the host passes are scipy and numpy, whose
# threaded BLAS calls are vector norms)
HOST_THREADS = 4
THREAD_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# the mixes' closed loop of one client is the only load the harness makes
LOOPS = {("closed", 1)}
# how a mix draws each step's Jacobian values
VALUE_KINDS = ("nonzeros", "fields")
# steps whose phases the log lists, one line each: the first ones, and
# every one past the refiner's plain refinement (two corrections) or
# failed
LOGGED_STEPS = 16


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def use_checkout_caches() -> None:
    """Point the build and kernel caches into the checkout, and fix the
    host's thread pools (before numpy or torch is imported)."""
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(ROOT / "build" / sub)
    for var in THREAD_ENV:
        os.environ[var] = "1"


def card_state(cuda: bool) -> str:
    """The card's clocks, power and temperature (nvidia-smi), for the
    log."""
    if not cuda:
        return "no card"
    import subprocess
    q = "clocks.sm,clocks.mem,power.draw,temperature.gpu,pstate"
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return f"card {q} {smi.stdout.strip()}"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"run.py: no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics the cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def problem(name: str, config: dict) -> dict:
    """The configuration's CSR and index maps, from the cache or built by
    the frozen stage 1 (keyed by stage 1's inputs and its source)."""
    from benchmark.reference import stage1
    if config["coupled_tracer_cnt"] != 1:
        raise SystemExit(f"run.py: {name}: the frozen stage 1 assembles one "
                         f"tracer, not {config['coupled_tracer_cnt']}")
    inputs = {k: config[k] for k in ("grid", "circulation_seed", "assembly")}
    h = hashlib.sha256(json.dumps(inputs, sort_keys=True).encode())
    h.update(Path(stage1.__file__).read_bytes())
    path = CACHE / name / f"{h.hexdigest()[:16]}.npz"
    import numpy as np
    if not path.exists():
        arrays = stage1.assemble(config)
        path.parent.mkdir(parents=True, exist_ok=True)
        # one temporary name a process: parallel test workers build the
        # same matrix at once
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class FieldUpdate:
    """The program's side of a ``fields`` mix: the port's update plan of
    the configuration's assembly, which makes each step's values on the
    card.

    Set-up builds the port's ``Assembly`` from the frozen stage 1's
    circulation (held in memory, ``DictFieldSource``) and its update plan,
    which checks itself bit for bit against the configuration's CSR; it
    uploads the stacked fields, the seed's pool of z (``reference/fields``)
    and one index that maps stage 1's slot-major order of the pool onto the
    plan's stacked layout. A step then slices the pool at its offset,
    gathers it into that layout, forms c = 1 + scale z on the card, folds
    ``stacked0 * c`` into the CSR's values and copies them to the host."""

    def __init__(self, config: dict, matrix, seed: int, scale: float, dev):
        import numpy as np
        import torch

        from benchmark.reference import fields, stage1
        from nk_ocn_tracer_jacobian_precond_tpu_torch.grid import (
            Grid, gen_ind_maps)
        from nk_ocn_tracer_jacobian_precond_tpu_torch.ops import (
            AssemblyOptions, PerTracerOptions, assemble_jacobian,
            device_update)
        from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.fieldsource import (
            DictFieldSource)
        from nk_ocn_tracer_jacobian_precond_tpu_torch.ops.hmix import IRF_NAME

        g, a = config["grid"], config["assembly"]
        imt, jmt, km = g["imt"], g["jmt"], g["km"]
        f = stage1.circulation(imt, jmt, km, config["circulation_seed"],
                               a["adv_type"])
        unused = np.zeros((jmt, imt))    # the assembly reads no TLONG, TLAT
        grid = Grid(imt=imt, jmt=jmt, km=km, z_t=f["z_t"], dz=f["dz"],
                    TLONG=unused, TLAT=unused, KMT=f["KMT"], KMU=f["KMU"],
                    TAREA=f["TAREA"])
        data = {k: f[k] for k in ("UVEL", "VVEL", "WVEL", "DXU", "DYU",
                                  "VDC_S", "VDC_GM")}
        for c in range(36):          # (ip, jp, kp) row-major
            data[IRF_NAME.format(c // 9 + 1, c // 3 % 3 + 1, c % 3 + 1)] = \
                f["IRF"][c]
        for name, (pos, neg) in f["POS_NEG"].items():
            data[f"{name}_POS"], data[f"{name}_NEG"] = pos, neg
        opts = AssemblyOptions(
            day_cnt=a["day_cnt"], adv_type=a["adv_type"],
            l_adv_enforce_divfree=a.get("l_adv_enforce_divfree", True),
            hmix_type=a["hmix_type"], vmix_type=a["vmix_type"],
            per_tracer=[PerTracerOptions(sink_type=a["sink_type"],
                                         sink_rate=a["sink_rate"])])
        asm = assemble_jacobian(grid, opts, DictFieldSource(data), None,
                                gen_ind_maps(grid.KMT, km))
        self.plan = device_update.build_update_plan(asm, matrix)
        slots = fields.slot_offsets(a["adv_type"])
        keys = [("self", 0) if off == stage1.SELF else ("shared", off)
                for off in slots]
        if set(self.plan.layout) != set(keys):
            raise SystemExit(f"run.py: the update plan holds fields "
                             f"{sorted(set(self.plan.layout) - set(keys))} "
                             f"that stage 1's slots do not")
        cells = km * jmt * imt
        idx = np.empty(self.plan.total, dtype=np.int64)
        for s, key in enumerate(keys):
            base = self.plan.layout[key][0]
            idx[base:base + cells] = np.arange(s * cells, (s + 1) * cells)
        self.seed, self.scale, self.length = seed, scale, len(slots) * cells
        self.offset = fields.offset
        self.idx = torch.from_numpy(idx).to(dev)
        self.stacked0 = torch.from_numpy(self.plan.stack_fields(asm)).to(dev)
        self.pool = torch.from_numpy(fields.pool(seed, self.length)).to(dev)

    def __call__(self, index: int):
        """Step ``index``'s values, on the host."""
        o = self.offset(self.seed, index, self.length)
        z = self.pool[o:o + self.length][self.idx]
        c = 1.0 + self.scale * z.double()
        return self.plan.update(self.stacked0 * c).cpu().numpy()


class Run:
    """What a run recorded, for the metric readers: ``setup_s``,
    ``window_s``, ``steps`` (one dict per step: index, phase "warmup",
    "window" or "traced", refactor seconds and the facade's split, solve
    seconds, latency, right-hand sides, the refiner's stats),
    ``peak_bytes``, ``trace`` (the profiled steps' summary, or None),
    ``stages`` (the stage timer's recording, or None), ``plans``,
    ``nnz``, ``dtype``, ``config``, ``traffic`` and ``card`` (whether it
    ran on a CUDA card: device metrics read nothing otherwise)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def window(self) -> list:
        return [s for s in self.steps if s["phase"] == "window"]


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", precision: str | None = None,
             refine: bool = True, log=print) -> dict:
    """Run one cell; returns the result (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, optionally ``breakdown``, then
    ``checks``). ``precision`` and ``refine`` replace the configuration's
    factor precision and the refined solve: the control's lower-precision
    path (``benchmark/control.py``); the benchmark's runs leave them."""
    import torch

    from benchmark import trace as tr
    from benchmark.reference import check, fields
    from nk_ocn_tracer_jacobian_precond_tpu_torch.device import resolve_device
    from nk_ocn_tracer_jacobian_precond_tpu_torch.grid.indmap import (
        IndexMaps)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.io.matrixfile import (
        SparseMatrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.mf import (
        MultifrontalFactorization)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.solver.symbolic import (
        symbolic_from_matrix)
    from nk_ocn_tracer_jacobian_precond_tpu_torch.utils.profiling import (
        STAGES)

    t_imported = time.perf_counter()
    cell = find(spec["workloads"], workload, "workload")
    centry = find(spec["configs"], cell["config"], "config")
    config = load_json(ROOT / centry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    if (traffic["loop"], traffic["clients"]) not in LOOPS:
        raise SystemExit(f"run.py: {cell['traffic']}: a {traffic['loop']} "
                         f"loop of {traffic['clients']} clients; the harness "
                         f"drives {sorted(LOOPS)}")
    kind = traffic.get("values", "nonzeros")
    if kind not in VALUE_KINDS:
        raise SystemExit(f"run.py: {cell['traffic']}: values {kind!r}; the "
                         f"harness draws {VALUE_KINDS}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    prob = problem(cell["config"], config)
    n = int(prob["tracer_state_len"])
    colind, rowptr = prob["colind"], prob["rowptr"]
    maps = IndexMaps(tracer_state_len=n, int3_to_ind=prob["int3_to_ind"],
                     ind_to_i=prob["ind_to_i"], ind_to_j=prob["ind_to_j"],
                     ind_to_k=prob["ind_to_k"])
    update = None
    if kind == "fields":
        # the configuration's own values first (the cold factor); each
        # step's from the program's update, made once set-up has built it
        def new_values(index: int):
            return prob["nzval"] if index == 0 else update(index)
    else:
        new_values = check.Values(prob["nzval"], seed,
                                  traffic["value_perturbation"])

    def matrix(index: int) -> SparseMatrix:
        return SparseMatrix(nzval=new_values(index), colind=colind,
                            rowptr=rowptr,
                            coupled_tracer_cnt=config["coupled_tracer_cnt"])

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t_problem = time.perf_counter()
    sym = symbolic_from_matrix(maps, matrix(0), leaf_size=config["leaf_size"])
    t_symbolic = time.perf_counter()
    prec = precision or config["factor_precision"]
    fac = MultifrontalFactorization(
        matrix(0), sym=sym, refine_tol=config["refine_tol"], device=dev,
        precision=prec)
    sync()
    t_cold = time.perf_counter()
    if kind == "fields":
        update = FieldUpdate(config, matrix(0), seed,
                             traffic["field_perturbation"], dev)
        sync()
    t_plan = time.perf_counter()
    refactor = traffic["refactor_every_step"]
    nrhs = traffic["rhs_per_step"]
    steps: list[dict] = []

    def step(phase: str) -> None:
        index = len(steps) + 1
        rec = dict(index=index, phase=phase, nrhs=nrhs)
        t0 = time.perf_counter()
        if refactor:
            with torch.profiler.record_function("bench.values"):
                m = matrix(index)
            rec["values_s"] = time.perf_counter() - t0
            with torch.profiler.record_function("bench.refactor"):
                t_r = time.perf_counter()
                fac.refactor(m)
                rec["refactor_s"] = time.perf_counter() - t_r
            split = ("to_scipy", "equilibrate", "rebind", "factor")
            if all(k in fac.timings for k in split):
                rec["split"] = {k: fac.timings[k] for k in split}
        t_b = time.perf_counter()
        B = check.step_rhs(n, seed, index, nrhs)
        rec["rhs_s"] = time.perf_counter() - t_b
        with torch.profiler.record_function("bench.solve"):
            t_s = time.perf_counter()
            X = fac.solve(B, refine=refine)
            sync()
            t1 = time.perf_counter()
        rec.update(t0=t0, t1=t1, solve_s=t1 - t_s, latency_s=t1 - t_s, X=X)
        if refine and fac._refiner is not None:
            st = fac._refiner.stats
            rec["refiner"] = {k: st[k] for k in ("host_applies", "cycles",
                                                 "outers", "rels")}
        steps.append(rec)

    before = card_state(cuda)
    t_state = time.perf_counter()
    for _ in range(traffic["warmup_steps"]):
        step("warmup")
    sync()
    t_start = time.perf_counter()
    age = process_age_s()
    setup_s = age - (time.perf_counter() - t_start)
    cpu0 = os.times()
    while time.perf_counter() - t_start < seconds:
        step("window")
    window_s = time.perf_counter() - t_start
    cpu1 = os.times()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    after = card_state(cuda)
    summary = stages = None
    if trace:
        with tr.traced(dev) as held:
            for _ in range(traffic["traced_steps"]):
                step("traced")
        summary = tr.summarize(held["prof"]) if cuda else None
        del held
        if refactor:
            with STAGES.recording(dev) as rec_t:
                step("traced")
            stages = dict(excl=dict(rec_t.excl), rounds=[
                dict(round=r["round"], excl=dict(r["excl"]))
                for r in rec_t.rounds])
    # the last factors applied once without refinement: the engine's own
    # factor quality, which refinement would hide
    b_raw = check.raw_apply_rhs(n, seed)
    x_raw = fac.solve(b_raw, refine=False)
    raw_index = steps[-1]["index"] if refactor else 0
    plans = fac.engine.plans
    dtype = str(fac.engine.prec).removeprefix("torch.")
    nnz = int(len(prob["nzval"]))
    del fac, sym, update
    if cuda:
        torch.cuda.empty_cache()

    run = Run(setup_s=setup_s, window_s=window_s, steps=steps,
              peak_bytes=peak, trace=summary, stages=stages, plans=plans,
              nnz=nnz, dtype=dtype, config=config, traffic=traffic,
              card=cuda)
    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the reference: every step's solutions (warm-up, window and traced),
    # judged against values it draws itself
    t_judge = time.perf_counter()
    if kind == "fields":
        # the reference's own fields, pattern and draws
        ref_values = fields.FieldValues(config, seed,
                                        traffic["field_perturbation"])
        ref = check.Reference(ref_values.nzval0, ref_values.colind,
                              ref_values.rowptr, seed, 0.0)
    else:
        ref = check.Reference(prob["nzval"], colind, rowptr, seed,
                              traffic["value_perturbation"])
        ref_values = ref.values
    limits = config["limits"]
    worst, failed_idx = 0.0, set()
    by_values: dict = {}
    for s in steps:
        by_values.setdefault(s["index"] if refactor else 0, []).append(s)
    for index, group in by_values.items():
        rels = ref.residuals(
            ref_values(index), [s.pop("X") for s in group],
            [check.step_rhs(n, seed, s["index"], nrhs) for s in group])
        for s, rel in zip(group, rels):
            s["judged"] = float(rel.max())
            worst = max(worst, s["judged"])
            if not rel.max() <= limits["max_rel_residual"]:
                failed_idx.add(s["index"])
    raw = float(ref.residuals(ref_values(raw_index), [x_raw],
                              [b_raw])[0].max())
    judge_s = time.perf_counter() - t_judge
    checks = {"max_rel_residual": {"value": worst,
                                   "limit": limits["max_rel_residual"]},
              "raw_apply_rel_residual": {
                  "value": raw, "limit": limits["raw_apply_rel_residual"]}}
    window = run.window()
    failed = sum(1 for s in window if s["index"] in failed_idx)
    correct = (not failed_idx and all(c["value"] <= c["limit"]
                                      for c in checks.values()))
    device_out = dict(platform="gpu" if cuda else "cpu",
                      kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                      count=cell["chips"], memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=len(window), failed=failed,
               metrics=metrics, device=device_out)
    if summary is not None:
        device_out.update(busy_s=summary["busy_s"],
                          window_s=summary["window_s"])
        out["breakdown"] = {k: summary[k] for k in ("device_ops",
                                                    "idle_gaps")}
    def past_plain(s) -> bool:
        st = s.get("refiner", {})
        return st.get("cycles", 0) > 0 or st.get("host_applies", 0) > 2

    past = [s for s in steps if past_plain(s)]
    for s in steps:
        if not (s["index"] <= LOGGED_STEPS or past_plain(s)
                or s["index"] in failed_idx):
            continue
        log(f"#   step {s['index']} {s['phase']}: "
            + " ".join(f"{k} {s[k]:.4f}" for k in (
                "values_s", "refactor_s", "rhs_s", "solve_s") if k in s)
            + f" of {s['t1'] - s['t0']:.4f} s; " + " ".join(
                f"{k} {v:.4f}" for k, v in s.get("split", {}).items())
            + "; refiner " + " ".join(
                f"{k} {v}" for k, v in s.get("refiner", {}).items()
                if k != "rels")
            + " rels " + " ".join(
                f"{r:.2e}" for r in s.get("refiner", {}).get("rels", []))
            + (f"; judged {s['judged']:.3e}" if "judged" in s else ""))
    lat = [s["latency_s"] for s in window]
    t0 = t_start - age     # the process's start on the same clock
    log(f"# set-up {setup_s:.3f} s: to run_cell's imports "
        f"{t_imported - t0:.3f}, matrix {t_problem - t_imported:.3f}, "
        f"symbolic {t_symbolic - t_problem:.3f}, cold factor "
        f"{t_cold - t_symbolic:.3f}, update plan {t_plan - t_cold:.3f}, "
        f"card state {t_state - t_plan:.3f}, "
        f"warm-up {t_start - t_state:.3f}")
    log(f"# window: process cpu {cpu1.user - cpu0.user:.3f} s user "
        f"{cpu1.system - cpu0.system:.3f} s system of {window_s:.3f} s; "
        f"before {before}; after {after}")
    log(f"# {workload} seed {seed}: set-up {setup_s:.3f} s, window "
        f"{window_s:.3f} s, {len(window)} steps of {nrhs} rhs "
        f"({len(lat)} latency samples), all {len(steps)} steps judged in "
        f"{judge_s:.3f} s, {dtype} factors, peak {peak / 1e9:.3f} GB")
    log(f"# {len(past)} of {len(steps)} steps went past plain refinement"
        + (f", judged up to {max(s['judged'] for s in past):.3e}"
           if past else ""))
    out["checks"] = checks
    return out


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout_caches()
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = find(spec["workloads"], args.workload, "workload")
    import torch
    torch.set_num_threads(HOST_THREADS)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), this machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace),
                   log=lambda s: print(s, file=sys.stderr, flush=True))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"run.py: the process has loaded {found}", file=sys.stderr)
        return 3
    print(f"# {power_limit()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
