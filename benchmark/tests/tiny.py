"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
narrow widths of the port's `tiny` preset (the frontend's ResNet-18 stays
whole; the training cell's Conformer 128 wide), in the configuration's
"arch" for the reference and as overrides for the port, and short
traffic."""

from __future__ import annotations

import time

from benchmark import harness
from benchmark.run import RunContext, execute

PORT = {"model.conformer.dim": 32, "model.conformer.ffn_dim": 64, "model.conformer.heads": 2,
        "model.conformer.layers": 1, "vocoder.model_in_dim": 96, "vocoder.embedding_dim": 8,
        "vocoder.upsample_initial_channel": 64, "vocoder.resblock_kernel_sizes": (3,),
        "vocoder.resblock_dilation_sizes": ((1, 3, 5),)}
TRAIN = {"model.conformer.dim": 128, "model.conformer.ffn_dim": 256, "model.conformer.heads": 4,
         "model.conformer.layers": 2}
AVHUBERT = {"model.frontend.encoder_dim": 64, "model.frontend.encoder_heads": 2,
            "model.frontend.encoder_ffn_dim": 128, "model.frontend.encoder_layers": 1,
            "model.conformer.input_dim": 64}


def cell(name: str, config: str | None = None):
    """(cell, port overrides) of `name` at the tiny size, with the
    configuration file `config` in place of the cell's where given."""
    c = harness.load_cell(name)
    if config is not None:
        c.config = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    a = c.config["arch"]
    a["conformer"].update(dim=32, ffn_dim=64, heads=2, layers=1)
    a["vocoder"].update(model_in_dim=96, embedding_dim=8, upsample_initial_channel=64,
                        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]])
    overrides = dict(PORT)
    if a["frontend"] == "avhubert":
        a["avhubert"].update(dim=64, heads=2, ffn_dim=128, layers=1)
        a["conformer"]["input_dim"] = 64
        overrides.update(AVHUBERT)
    t = c.traffic
    if t["driver"] == "serve_closed":
        t.update(clients=2, max_batch=2, lengths_per_client=4, segment=16, checked=3, frame_bank=64,
                 lengths={"dist": "uniform", "low": 20, "high": 40}, trace_after_s=0.0,
                 trace_seconds=0.5)
    else:
        # at 32 wide the bfloat16 control's first loss and gradient stay
        # within the card's limits; at 128 they part from float32's
        a["conformer"].update(dim=128, ffn_dim=256, heads=4, layers=2)
        overrides.update(TRAIN)
        t.update(batch_size=2, pad_to=48, lengths={"dist": "uniform", "low": 30, "high": 48},
                 trace_from_update=0, trace_updates=1)
    return c, overrides


def rehearse(name: str, seed: int = 2 ** 31 + 77, seconds: float = 2.0, trace: bool = False,
             dtype: str | None = None, hooks: dict | None = None,
             traffic: dict | None = None) -> dict:
    c, overrides = cell(name)
    c.traffic.update(traffic or {})
    return execute(RunContext(cell=c, seed=seed, seconds=seconds, trace=trace, device="cpu",
                              t_start=time.perf_counter(), dtype=dtype, overrides=overrides,
                              hooks=hooks or {}))


CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
