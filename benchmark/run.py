"""One run of one cell of BENCHMARK.json on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernels' libraries,
weights made on the card from the seed, every shape the cell's traffic
uses) is timed as `setup_s`; the window then runs the cell's traffic for
`--seconds`; what the window produced is then held against the plain
reference (benchmark/reference). The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device and, traced, a
breakdown; each number compared is printed beside its limit as the last
lines of standard error and under "checks", the line's last key.

Exits non-zero, with no result, without as many CUDA cards as the cell
asks for, when the port's package cannot be imported, and when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / "_cache"      # fixed, inside the checkout


def _environment() -> None:
    """Caches inside the checkout at fixed paths, and no JAX from a library."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the checkout's root, not this directory, on the path: the benchmark's
    # modules are imported as `benchmark.<name>` and shadow nothing
    here = str(ROOT / "benchmark")
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    sys.path.insert(0, str(ROOT))


@dataclass
class RunContext:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = T_START
    dtype: str | None = None           # None: the configuration's
    overrides: dict = field(default_factory=dict)
    hooks: dict = field(default_factory=dict)


def execute(rc: RunContext) -> dict:
    """Run the cell and assemble the result line (a dict)."""
    import torch

    from benchmark import harness, trace

    driver = importlib.import_module(f"benchmark.drivers.{rc.cell.traffic['driver']}")
    out = driver.run(rc)
    cell = rc.cell
    ok, checks = harness.checks(out["numbers"], cell.limits["limits"])
    correct = ok and out["failed"] == 0
    if rc.device == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                  "memory_peak_bytes": out["memory_peak_bytes"]}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if not rc.trace:
        values = {**out["e2e"], "setup_s": out["setup_s"]}
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        view = out.get("view")
        if view is not None:
            for m in cell.per_layer:
                v = cell.readers[m["name"]].read(view)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            device["busy_s"], device["window_s"] = view.busy_s, view.window_s
            result["breakdown"] = trace.breakdown(view)
        else:
            print("trace: no profiled window", file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = device
    result["counts"] = {**out.get("counts", {}),
                        **{k: v for k, v in out["numbers"].items() if k not in checks}}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    _environment()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    try:
        cell = harness.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), found {have}; "
              "it never runs on the CPU", file=sys.stderr)
        return 3
    result = execute(RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace)))
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {bad}; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
