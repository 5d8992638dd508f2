"""Bytes per entry of the row-quantum PELL layout on the row layout's
main-path matrices, packed on the host (no card needed):

    python -m spmv_scpa_tpu_torch.bench.layout_bytes

Prints, for ``powerlaw100k`` at f32 and fp64 and for ``webbase1m``'s
compact tail (the hybrid's big tail), the quantum the host rule picks,
the fill, the plan's ``hbm_bytes`` and ``hbm_bytes / nnz``, and the
byte cost the rule weighs for each quantum.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.ops import lane_ell, pell, pell_rows


def report(name, A, dtype=torch.float32) -> None:
    plan = pell.plan_rows(A, dtype)
    lens = np.diff(A.irp)
    item = plan.vals.itemsize
    costs = []
    for q in pell_rows.QUANTA:
        quanta = int((-(-lens // q)).sum())
        costs.append(f"Q{q} {quanta * q * (item + 4) + quanta * 4}")
    print(f"[{name}] {A.m} rows, {A.nnz} nnz, {dtype} | Q {plan.quantum} "
          f"fill {plan.meta['fill']:.4f} hbm_bytes {plan.hbm_bytes} = "
          f"{plan.hbm_bytes / max(A.nnz, 1):.2f} B/nnz | rule's bytes: "
          + ", ".join(costs), flush=True)


def main() -> int:
    A = cases.powerlaw100k()
    report("powerlaw100k", A)
    report("powerlaw100k-fp64", A, torch.float64)
    W = cases.webbase1m()
    tail, _ = lane_ell.compact_tail(W, lane_ell.pack_lane_ell(W))
    report("webbase1m-tail", tail)
    return 0


if __name__ == "__main__":
    sys.exit(main())
