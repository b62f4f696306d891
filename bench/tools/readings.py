"""The readings that a cell's limits are set from: the compared numbers
of sound runs of the program over many seeds, of the control (the
reference in the precision below the configuration's, in the program's
place) and of planted faults, at the cell's own size, in one process.

    python3 bench/tools/readings.py --workload <name> --seeds 11,12,13 \\
        --seconds 2 [--control] [--fault half_batch]

Each seed prints one JSON line: the program's (or the faulted program's)
numbers and, with ``--control``, the control's.
"""
import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench.lib import faults, registry  # noqa: E402
from bench.lib.trace import Spans  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = registry.Cell(registry.load_benchmark(), a.workload)
    driver = cell.driver()
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        run = driver.make(cell, seed, device, Spans())
        with faults.FAULTS[a.fault]() if a.fault else nullcontext():
            run.setup()
            run.window(a.seconds)
        run.end_to_end()
        run.release()
        torch.cuda.empty_cache()
        out = {"seed": seed, "program": a.fault or "sound",
               "numbers": {k: v for k, (v, _) in run.check().items()},
               "attempted": run.attempted}
        if hasattr(run, "prog_loss"):     # a bank: each round's loss gap
            from bench.reference import compare
            out["loss_by_round"] = [
                compare.loss_gap([p], [torch.stack([r["loss"][k]
                                                    for r in run.ref])])
                for k, p in enumerate(run.prog_loss)]
        if a.control:
            out["control"] = {k: v for k, (v, _) in run.control().items()}
            if hasattr(run, "ctl"):
                from bench.reference import compare
                out["control_loss_by_round"] = [
                    compare.loss_gap([torch.stack([c["loss"][k]
                                                   for c in run.ctl])],
                                     [torch.stack([r["loss"][k]
                                                   for r in run.ref])])
                    for k in range(len(run.ref[0]["loss"]))]
        out["s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
