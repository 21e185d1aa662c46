"""Cells of the benchmark cut to a size the CPU tests can run: the same
families, entries, optimizer settings and limits, tiny widths and depths
(test-only; the benchmark's runs never read this)."""
from __future__ import annotations

import copy
import json
from typing import Dict

from perfbench import harness

TINY = {
    "gpt2": ({"n_embd": 64, "n_head": 4, "n_layer": 4, "n_positions": 64,
              "n_ctx": 64, "vocab_size": 257},
             {"n_embd": 48, "n_head": 3, "n_layer": 2, "n_positions": 64,
              "n_ctx": 64, "vocab_size": 257}),
    "phi3": ({"hidden_size": 96, "num_attention_heads": 6,
              "num_key_value_heads": 2, "intermediate_size": 128,
              "num_hidden_layers": 4, "vocab_size": 301},
             {"hidden_size": 48, "head_dim": 8, "num_attention_heads": 6,
              "num_key_value_heads": 2, "intermediate_size": 64,
              "num_hidden_layers": 2, "vocab_size": 301}),
}
TRAFFIC = {"kind": "causal_lm_batches", "rows": 4, "seq": 32, "pool": 4,
           "corpus": {"branch": 4, "noise": 0.05, "zipf": 1.5}}


def bench() -> Dict:
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def cell(name: str, dtype: str = "float32", **workload) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json at smoke size, its parameters
    in ``dtype``; ``workload`` overrides keys of its workload file."""
    b = bench()
    real = harness.load_cell(b, name)
    config = copy.deepcopy(real.config)
    target, source = TINY[config["reference"]]
    config.update(target, torch_dtype=dtype)
    config["source_model"].update(source, torch_dtype=dtype)
    work = dict(copy.deepcopy(real.workload), reference_block_rows=2,
                **workload)
    return harness.Cell(name, config, dict(TRAFFIC), work,
                        end_to_end=b["end_to_end"], per_layer=b["per_layer"])
