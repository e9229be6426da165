"""The port's benchmark: one cell, one seed, one measured window.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell names a configuration and a
traffic mix in ``BENCHMARK.json``; the configuration's file, the traffic
file (``portbench/traffic/<traffic>.json``) and the driver it names
(``portbench/drivers/<driver>.py``) do the rest. A run draws its inputs and
weights from the seed, warms up (set-up), measures for ``--seconds``, checks
the window's answers against the plain reference (``portbench/reference``)
and prints one JSON line last on standard output. With ``--trace 1`` the
window runs under ``torch.profiler`` and the line carries the cell's
per-layer metrics, each read by ``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (falls back to now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ark_tpu")
CACHE = os.path.join(ROOT, ".portbench_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(name: str):
    """(benchmark, cell, configuration, traffic) for the cell `name`."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return bench, cell, cfg, traffic


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer")."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, records: dict):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(records)


def _fail(msg: str, code: int = 3):
    print(msg, file=sys.stderr)
    raise SystemExit(code)


def main(argv=None, device: str = "cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, cfg, traffic = load_cell(args.workload)
    traced = bool(args.trace)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    try:
        import torch
        import ark_tpu_torch  # noqa: F401  the system under test
    except ImportError as exc:
        _fail(f"cannot import the system under test: {exc}")
    from portbench import hw, trace

    if device == "cuda":
        if not torch.cuda.is_available():
            _fail("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            _fail(f"the cell needs {cell['chips']} cards, {torch.cuda.device_count()} found")

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    drv_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    workdir = tempfile.mkdtemp(prefix="portbench-")
    checks, check_error, readings = {}, None, {}
    try:
        driver = drv_mod.Driver(cfg, traffic, args.seed, device, workdir)
        driver.setup()
        sync()
        setup_s = time.time() - T_START
        # a traced run profiles a window of the traffic's `trace_seconds` at
        # most: its per-layer readings are shares and rates, and a profiler
        # over every call of a long window costs minutes to read
        seconds = min(args.seconds, traffic.get("trace_seconds", args.seconds)) \
            if traced else args.seconds
        with trace.profiled(traced) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                e2e = driver.window(seconds, traced)
                sync()
        if traced:
            readings = trace.read(prof)
            del prof
            driver.traced_extras()
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        driver.release()
        try:
            checks = driver.check()
        except Exception as exc:        # the check itself failing decides `correct`
            check_error = f"{type(exc).__name__}: {exc}"
        records = dict(driver.records, **readings, cell=args.workload, cfg=cfg,
                       traffic=traffic)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    found = forbidden_modules()
    if found:
        _fail(f"modules of JAX or the JAX package are loaded: {found}")

    e2e["setup_s"] = setup_s
    metrics = {}
    for m in metrics_of(bench, args.workload, "per_layer" if traced else "end_to_end"):
        value = read_metric(m["name"], records) if traced else e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cfg["limits"]
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}
    ok = (check_error is None and bool(checks) and records.get("failed", 0) == 0
          and all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in compared.values()))
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": records.get("attempted", 0),
              "failed": records.get("failed", 0), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = readings["busy_s"]
        dev["window_s"] = readings["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in readings["device_ops"]],
                               "idle_gaps": [list(x) for x in readings["idle_gaps"]]}
    result["card"] = hw.name_and_power() if device != "cpu" else "cpu"
    result["checks"] = compared
    summary = {k: v for k, v in records.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    print(f"records {json.dumps(summary)}", file=sys.stderr)
    for err in records.get("errors", []):
        print(f"error in the window: {err}", file=sys.stderr)
    if check_error:
        print(f"check failed: {check_error}", file=sys.stderr)
    for k, c in compared.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
