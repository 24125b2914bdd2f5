"""Run one cell of the benchmark once and print one JSON line.

    python3 -m perfcells.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the program's objects, inputs made from the
seed, one warm pass over every shape the cell uses) is ``setup_s``. The
window then runs the cell's closed loop for ``--seconds``; with
``--trace 1`` under ``torch.profiler``, and the line carries the cell's
per-layer metrics instead of its end-to-end ones. After the window the
program's state is freed and the plain reference judges what the window
produced: ``correct``, with every number compared beside its limit, as
the last lines on standard error and under ``checks`` in the line.

Exits nonzero, and prints no result, without a CUDA card (or with fewer
than the cell asks for), when the program cannot be imported, or when
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded in this process.
"""

import os
import time

_T_START = time.perf_counter()

# one process with few threads: the host loops of the cells run on one
# core, and idle worker pools only add jitter (set before numpy or torch
# is imported)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names the process may not hold: the port runs alone
FORBIDDEN = ("jax", "jaxlib", "flax", "reconplan_tpu")


def cache_env(root=ROOT):
    """Fixed build and kernel cache directories inside the checkout, so
    that only a checkout's first run builds. The port builds its kernels
    into ``reconplan_tpu_torch/_build/`` itself."""
    cache = os.path.join(root, "perfcells", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_module(path, name):
    """Import the Python file at ``path`` as module ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, looked up by name."""

    def __init__(self, root=ROOT):
        self.root = root
        self.manifest = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name):
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name):
        """The cell's own file: its driver, traffic and limits."""
        return load_json(os.path.join(self.root, "perfcells", "cells",
                                      name + ".json"))

    def config(self, name):
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def driver(self, name):
        return load_module(os.path.join(self.root, "perfcells", "drivers",
                                        name + ".py"),
                           "perfcells_driver_" + name)

    def reader(self, metric):
        return load_module(os.path.join(self.root, "perfcells", "metrics",
                                        metric + ".py"),
                           "perfcells_metric_" + metric.replace(".", "_"))

    def end_to_end(self, cell):
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.manifest["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        """The per-layer metrics ``cell`` reports: those that list it."""
        return [m for m in self.manifest["per_layer"]
                if cell in m["workloads"]]


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(argv=None, root=ROOT, require_card=True):
    """One run; returns (exit code, result dict or None)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(root)
    bench = Bench(root)
    wl = bench.workload(args.workload)
    cell = bench.cell(args.workload)
    config = bench.config(wl["config"])

    import torch

    from perfcells import trace as tr

    if require_card and not (torch.cuda.is_available()
                             and torch.cuda.device_count() >= wl["chips"]):
        print(f"perfcells: {args.workload} needs {wl['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2, None
    device = torch.device("cuda" if require_card else "cpu")
    driver = bench.driver(cell["driver"])
    state = driver.setup(cell, config, args.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _T_START

    spans = tr.Spans(bool(args.trace))
    trace = None
    if args.trace:
        # the traced window is the cell's own length, at most --seconds:
        # its metrics are ratios, and the reading of a long trace would
        # outlast the run's time
        seconds = min(args.seconds, cell.get("trace_seconds", args.seconds))
        with tr.profiled() as prof:
            t0 = time.time_ns()
            out = driver.window(state, seconds, spans)
            t1 = time.time_ns()
        trace = tr.reduce(prof, t0, t1)
        del prof
    else:
        out = driver.window(state, args.seconds, spans)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": wl["chips"],
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    driver.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, work = driver.judge(state, out)

    if args.trace:
        ctx = SimpleNamespace(trace=trace, out=out, work=work)
        metrics = {}
        for m in bench.per_layer(args.workload):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev["busy_s"] = trace.busy_ns / 1e9
        dev["window_s"] = trace.window_ns / 1e9
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in bench.end_to_end(args.workload)}

    found = forbidden_modules()
    if found:
        print(f"perfcells: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3, None
    correct = all(c["value"] <= c["limit"] for c in checks)
    result = {
        "correct": correct,
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": dev,
    }
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0, result


def main(argv=None):
    code, result = run(argv)
    if result is not None:
        sys.stdout.flush()
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
