"""The benchmark's cells cut to a size the CPU runs in a second or two:
the same drivers, references and comparisons, narrower and with fewer
clusters."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL = {
    "table1-mlp": {"dims": [8, 16, 16, 8], "n_points": 600,
                   "batch": 4},
    "fig4-c100": {"n_clusters": 2},
    "starcoder2-3b": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                      "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                      "vocab_size": 512, "sliding_window": 48},
    "repo-prefill": {"length_min": 32, "length_max": 128,
                     "length_quantum": 16, "cycle": 8},
    "chat-batch": {"length_min": 16, "length_max": 64, "length_quantum": 16,
                   "cycle": 8},
}


def small_cell(workload: str):
    """The benchmark's cell ``workload`` at the CPU size above."""
    from bench.lib import registry
    cell = registry.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                         workload)
    cell.config = dict(cell.config, **SMALL[cell.config_entry["name"]])
    cell.traffic = dict(cell.traffic, **SMALL[cell.traffic_name])
    return cell
