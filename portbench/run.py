"""Run one cell of the port's benchmark once, on the CUDA card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json at the root of the
checkout. It names a configuration (``configs``: its file under
portbench/configs/) and a traffic mix (portbench/mixes/<traffic>.json,
which names its driver in portbench/drivers/). With ``--trace 0`` the run
measures the cell's end-to-end metrics over a window of ``--seconds``; with
``--trace 1`` a traced stretch of the same traffic gives its per-layer
metrics, each read by its own file portbench/metrics/<metric>.py. Both
judge what the timed calls produced against the plain reference
(portbench/reference/), with each cell's limits in
portbench/limits/<cell>.json, and print one JSON line last on standard
output.

It needs a CUDA card (as many as the cell's ``chips``) and exits 2
without one, printing no result; it never falls back to the CPU. It
imports torch, numpy and the port (geoformer_tpu_torch) only, and refuses
to report a run in which JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "geoformer_tpu")


def _environment() -> None:
    """One host thread for torch's and the BLAS libraries' pools (an idle
    pool's threads contend with the one that launches the work: runs
    spread 10 % and more with the default pool), every build and kernel
    cache at a fixed path inside the checkout (the port's own kernels
    build into geoformer_tpu_torch/_build/), and no JAX in libraries that
    could load it. Before torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    base = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_in(names):
    """The names among ``names`` (module names) whose top-level name is JAX
    or the JAX package, compared whole: geoformer_tpu_torch is not
    geoformer_tpu."""
    return sorted({n.split(".", 1)[0] for n in names}.intersection(
        FORBIDDEN))


def loaded_forbidden():
    return forbidden_in(list(sys.modules))


def load_cell(workload: str, root: Path = ROOT):
    """(cell, configuration, mix, benchmark) of a workload name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes" /
                      f"{cell['traffic']}.json").read_text())
    return cell, config, mix, bench


def _metric_reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, cell):
    """(end-to-end metric entries, per-layer entries) the cell reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in moved)]
    return e2e, per


def limits_of(cell_name: str):
    return json.loads((BENCH_DIR / "limits" /
                       f"{cell_name}.json").read_text())


def execute(cell, config, mix, bench, seed: int, seconds: float, trace: bool,
            device, t_start: float = T_START, limits=None, log=None):
    """One run of ``cell``: set-up, the window (or the traced stretch), the
    check against the reference. Returns the result dict (without the
    device's name)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    run = driver.Run(config, mix, seed, device, trace, log)
    run.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    e2e, per = cell_metrics(bench, cell)
    metrics = {}
    device_info = {}
    if trace:
        summary = run.traced()
        for m in per:
            value = _metric_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        per = 1e3 / summary["batches"]
        stretch = {"untraced_ms_per_batch": per * summary["untraced_s"],
                   "light_ms_per_batch": per * summary["window_s"],
                   "traced_ms_per_batch": per * summary["full_window_s"],
                   "traced_idle_pct": 100.0 * (1.0 - summary["full_busy_s"]
                                               / summary["full_window_s"])}
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    else:
        figures = run.window(seconds)
        figures["setup_s"] = setup_s
        window_record = {k: v for k, v in figures.items()
                         if k not in {m["name"] for m in e2e}}
        if cuda:
            figures["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for m in e2e:
            if m["name"] in figures:
                metrics[m["name"]] = {"value": figures[m["name"]],
                                      "unit": m["unit"]}
        breakdown, stretch = None, window_record
    if cuda:
        device_info["memory_peak_bytes"] = max(
            setup_peak, torch.cuda.max_memory_allocated())
    attempted, failed = run.attempted, run.failed
    run.free_program()
    numbers = {k: (float(v) if math.isfinite(v) else 1e30)
               for k, v in run.check().items()}
    limits = limits if limits is not None else limits_of(cell["name"])
    # a number the check could not read (no judged call) counts as failed
    checks = {k: {"value": numbers.get(k, 1e30), "limit": limits[k]}
              for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["record"] = {k: v for k, v in numbers.items() if k not in limits}
    result["record"].update(stretch)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, mix, bench = load_cell(args.workload)
    _environment()
    # the checkout's root in place of this script's folder, whose module
    # names (trace, gen) would shadow others
    sys.path[0] = str(ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = execute(cell, config, mix, bench, args.seed, args.seconds,
                     bool(args.trace), device)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    result["device"].update(platform="gpu",
                            kind=torch.cuda.get_device_name(0),
                            count=int(cell["chips"]))
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
