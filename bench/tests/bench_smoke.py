"""Smoke-size cells of the benchmark for the CPU tests: the cells' own
files with the population, cohort, widths and lengths cut down."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import harness  # noqa: E402

FL_CELL, LM_CELL = "hb-iot-c4096", "phi3-hfl5-t8"
FL_SMOKE = {"clients": 192, "cohort": 24, "page_slots": 192, "page_chunk": 64, "traced_rounds": 2}
# 8-18 samples a device (one or two local steps): with a cohort of 24 the
# cell's 16 local steps would leave the rounds' rounding noise unaveraged
FL_SMOKE_POPULATION = {"min_per_class": 0, "max_per_class": 2, "dom_boost": 8}
LM_SMOKE_CONFIG = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 4,
                   "num_hidden_layers": 2, "vocab_size": 256, "torch_dtype": "float32"}
LM_SMOKE_TRAFFIC = {"seq_len": 32, "batch_steps": 8}


def cell(name: str, seed: int = 7, seconds: float = 0.5, trace: bool = False, root: Path = ROOT) -> harness.Cell:
    """The cell as ``BENCHMARK.json`` and its files give it, cut to a size
    the CPU runs in seconds, on the CPU."""
    c = harness.load_cell(name, seed, seconds, trace, root=root, device="cpu")
    if c.traffic["driver"] == "fl_stream":
        c.traffic.update(FL_SMOKE)
        c.config["population"].update(FL_SMOKE_POPULATION)
    else:
        c.config.update(LM_SMOKE_CONFIG)
        c.traffic.update(LM_SMOKE_TRAFFIC)
    return c
