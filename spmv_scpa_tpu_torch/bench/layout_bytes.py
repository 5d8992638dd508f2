"""Bytes per entry of the row-quantum layouts on their main-path
matrices, packed on the host (no card needed; the flagship's packing
takes about a minute and several GB):

    python -m spmv_scpa_tpu_torch.bench.layout_bytes

Prints, for ``powerlaw100k`` at f32 and fp64 and for ``webbase1m``'s
compact tail (the hybrid's big tail), the quantum the host rule picks,
the fill, the plan's ``hbm_bytes`` and ``hbm_bytes / nnz``, and the
byte cost the rule weighs for each quantum. Then, for the lane-ELL core
of the flagship (bench knobs), ``amazon262k``, ``webbase1m`` and
``ext_windowed1m``: the core's entries, the rows layout's quantum,
slots per entry, share of 32-bit index blocks and bytes per core entry
(values, index, ``qptr``, ``blk_lo``, ``ctab``) beside the byte cost of
each quantum, and the lanes layout's plane count, slots per entry and
plane bytes per core entry.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC
from spmv_scpa_tpu_torch.ops import lane_ell, lane_rows, pell, pell_rows


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


def report_core(name, A, **knobs) -> None:
    """The lane-ELL core of ``A`` in both layouts, from one pack."""
    t0 = time.perf_counter()
    plan = lane_ell.pack_lane_ell(A, **knobs)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    core = lane_ell.rows_plan(A, plan)
    rows_s = time.perf_counter() - t0
    nnz = max(plan.core.size, 1)
    c = plan.core
    lens = np.bincount(A.row_ids()[c], minlength=A.m).astype(np.int64)
    costs = ", ".join(
        f"Q{q} {lane_rows.layout_bytes(A.row_ids()[c], A.ja[c].astype(np.int64), lens, q)}"
        for q in pell_rows.QUANTA)
    nb = core.ctab.shape[0]
    wide = int((core.ctab[:, 0] < 0).sum())
    cfg = plan.cfg
    slots = cfg.steps * cfg.chunk * BC * cfg.QT
    planes = cfg.steps * cfg.chunk * BC * plan.slot_bytes
    print(f"[{name}-core] {plan.core.size} core entries of {A.nnz} | rows: "
          f"Q {core.quantum} slots/entry {core.vals.size / nnz:.3f} 32-bit "
          f"blocks {wide}/{nb} ({wide / max(nb, 1):.1%}) bytes "
          f"{core.hbm_bytes} = {core.hbm_bytes / nnz:.2f} B/entry (rule's "
          f"bytes: {costs}) | lanes: QT {cfg.QT} slots/entry "
          f"{slots / nnz:.2f} planes {planes} = {planes / nnz:.2f} B/entry "
          f"| pack {pack_s:.2f} s, rows plan {rows_s:.2f} s", flush=True)


def main() -> int:
    A = cases.powerlaw100k()
    report("powerlaw100k", A)
    report("powerlaw100k-fp64", A, torch.float64)
    W = cases.webbase1m()
    tail, _ = lane_ell.compact_tail(W, lane_ell.pack_lane_ell(W))
    report("webbase1m-tail", tail)
    report_core("flagship", cases.flagship(), **cases.FLAGSHIP_KNOBS)
    report_core("amazon262k", cases.amazon262k())
    report_core("webbase1m", W)
    report_core("ext_windowed1m", cases.ext_windowed1m())
    return 0


if __name__ == "__main__":
    sys.exit(main())
