"""The readings the limits of a cell are set from, on the card, in one
process: the program on each of `--seeds`, the control (the port's own
bfloat16 path: the configuration's float32 one step down) on each of
`--control-seeds`, and each fault of benchmark/faults.py named in `--faults`
on the control seeds. Each run is a whole run of the cell (set-up, a short
window, the comparison); one JSON line a run goes to standard output and to
`--out`.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults half_the_batch] --seconds 5 --out <file>
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness  # noqa: E402
from benchmark.run import RunContext, _environment, execute  # noqa: E402


def main(argv=None) -> int:
    _environment()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = [("program", s, None, {}) for s in seeds(args.seeds)]
    runs += [("control", s, "bfloat16", {}) for s in seeds(args.control_seeds)]
    for name in [f for f in args.faults.split(",") if f]:
        kind = "pipeline" if name in faults.PIPELINE else "train_step"
        hook = {**faults.PIPELINE, **faults.TRAIN_STEP}[name]
        runs += [(name, s, None, {kind: [hook]}) for s in seeds(args.control_seeds)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for kind, seed, dtype, hooks in runs:
            t = time.perf_counter()
            res = execute(RunContext(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                                     t_start=t, dtype=dtype, hooks=hooks))
            line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                               "correct": res["correct"], "seconds": time.perf_counter() - t,
                               "numbers": {k: v["value"] for k, v in res["checks"].items()},
                               "counts": res["counts"], "metrics": res["metrics"]})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
