"""What every run shares: the cell's files found by name, the port built from
a configuration file and the seed, the precision settings, the per-layer
readers, and the checks against their limits.

A cell of BENCHMARK.json names a configuration (configs/<config>.json) and a
traffic mix (traffic/<traffic>.json); the mix names its driver
(drivers/<driver>.py), the cell's limits are limits/<cell>.json and each
per-layer metric is read by metrics/<metric>.py. Adding a cell, a mix, a
configuration or a metric adds files; none here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lip2speech_tpu")   # whole top-level names


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list            # manifest entries this cell reports
    per_layer: list
    readers: dict = field(default_factory=dict)    # per-layer name -> module


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files; raises
    KeyError or FileNotFoundError where one is missing."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name)]
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py", f"bench_metric_{i}")
               for i, m in enumerate(per_layer)}
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=per_layer, readers=readers)


def kernels_to_record(cell: Cell) -> dict:
    """key -> (module, function, shapes) of every kernel a reader of the
    cell counts work for."""
    out = {}
    for mod in cell.readers.values():
        launch = getattr(mod, "LAUNCH", None)
        if launch is not None:
            out[mod.KERNEL] = launch
    return out


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among `names` (default: sys.modules)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------- the port

def port_config(config: dict, extra: dict | None = None):
    """The port's PipelineConfig: the preset with the file's overrides (and
    a test's)."""
    from lip2speech_tpu_torch.core.config import preset, with_overrides

    overrides = {**config.get("overrides", {}), **(extra or {})}
    cfg = preset(config["preset"])
    return with_overrides(cfg, overrides) if overrides else cfg


def set_precision(config: dict) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"]["matmul"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"]["cudnn"])


def plain_precision() -> None:
    """The reference's: float32 with TF32 off everywhere."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_weights(cfg, seed: int, device, vocoder: bool = True) -> tuple[dict, dict | None]:
    """Random stage-1 (and vocoder) state dicts made on `device` from one
    generator seeded with `seed`, through the port's initialisers."""
    import torch
    from lip2speech_tpu_torch.models.layers import init_weights
    from lip2speech_tpu_torch.models.multi_target import MultiTargetModel
    from lip2speech_tpu_torch.models.vocoder import MelCodeGenerator

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        model = MultiTargetModel(cfg.model)
        voc = MelCodeGenerator(cfg.vocoder) if vocoder else None
    init_weights(model, gen)
    if voc is not None:
        init_weights(voc, gen)
    return model.state_dict(), None if voc is None else voc.state_dict()


def sub_seed(seed: int, k: int) -> int:
    """A seed of its own for each use of the run's seed (weights, data), so
    that no two generators share a stream."""
    return (seed * 1_000_003 + k) % 2 ** 63


def checks(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number passes at or under it; a
    missing or non-finite number fails)."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
