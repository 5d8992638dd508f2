"""The control of ``correct``: the reference put in the program's place
at the precision below the configuration's ``dtype``
(``reference.control_product``), read the way a run reads the program:
for a float32 configuration TF32 inputs and float32 sums, for a float64
one A's values rounded to float32 with X and the sums in float64.

    python3 -m spmv_bench.control --workload <cell> --seeds 1 2 3

builds the cell's inputs for each seed exactly as a run does
(``harness.inputs``), and prints one JSON line a seed with each number
of ``checks/<cell>.json`` over every X of the traffic (the widest, as a
run judges its sampled calls) beside the cell's limit. The control must
read past the limit on every seed; its smallest reading is the upper
end a limit is set below (``PERF.md``). The benchmark's own runs do not
run it. Imports nothing of the port.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from spmv_bench import reference
from spmv_bench.harness import inputs, value_dtype
from spmv_bench.spec import ROOT, load_cell


def readings(cell, seed: int, device) -> dict:
    """The control's widest reading of each number over the cell's X
    vectors for ``seed``."""
    mat, xs = inputs(cell, seed)
    dtype = value_dtype(cell.config)
    worst = {k: 0.0 for k in cell.checks["limits"]}
    for x in xs:
        X = torch.from_numpy(x).to(device)
        Y, S = reference.product(mat, X)
        got = reference.compare(reference.control_product(mat, X, dtype),
                                Y, S)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m spmv_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = load_cell(args.workload, ROOT)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    limits = cell.checks["limits"]
    for seed in args.seeds:
        worst = readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": worst, "limits": limits,
                          "fails": any(worst[k] > limits[k]
                                       for k in limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
