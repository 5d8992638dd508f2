"""Bytes per entry of the row-quantum layouts and of the bitmap BCSR
tiles on their main-path matrices, packed on the host (no card needed;
the flagship's packing takes about a minute and several GB):

    python -m spmv_scpa_tpu_torch.bench.layout_bytes          # all
    python -m spmv_scpa_tpu_torch.bench.layout_bytes bcsr     # BCSR only

Prints, for ``powerlaw100k`` at f32 and fp64 and for ``webbase1m``'s
compact tail (the hybrid's big tail), the quantum the host rule picks,
the fill, the plan's ``hbm_bytes`` and ``hbm_bytes / nnz``, and the
byte cost the rule weighs for each quantum. Then, for the lane-ELL core
of the flagship (bench knobs), ``amazon262k``, ``webbase1m`` and
``ext_windowed1m``: the core's entries, the rows layout's quantum,
slots per entry, share of 32-bit index blocks and bytes per core entry
(values, index, ``qptr``, ``blk_lo``, ``ctab``) beside the byte cost of
each quantum, and the lanes layout's plane count, slots per entry and
plane bytes per core entry. Then, for the flagship and ``stencil48k``
(the BCSR SpMV and SpMM paths), the dense (8, 128) tiles' bytes against
the bitmap tiles' (``ops/bcsr_bits.py``: values, masks, ``pan`` and
``vptr``, ``rowptr``), in all and per nonzero. Then the chips tails of
``amazon262k`` (a single plan), ``webbase1m`` at one row shard (the
split plan) and ``amazon262k`` at four shards: their chip slots and
entries, the slot products' bytes (``ops/chips_slots.py``: a 4-byte
column and value read and a 4-byte product written a slot) against the
two gather stages' (their stage-2 tables, values and gathered values a
slot, the stage-1 tables a hot slot and the zero-padded copy of x),
per entry. ``chips`` alone:

    python -m spmv_scpa_tpu_torch.bench.layout_bytes chips
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.formats.csr import BC
from spmv_scpa_tpu_torch.formats.panel_ell import BR
from spmv_scpa_tpu_torch.ops import (bcsr_bits, chips_slots, lane_ell,
                                     lane_rows, pell, pell_rows)
from spmv_scpa_tpu_torch.parallel import distributed


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


def bcsr_bytes(A) -> dict:
    """The dense tiles' bytes (values only, as the tile kernel streams
    them, without window padding) and the bitmap tiles' by array."""
    plan = bcsr_bits.plan_bcsr_bits(A)
    return {"nnz": A.nnz, "tiles": plan.num_tiles, "fill": plan.meta["fill"],
            "dense": plan.num_tiles * BR * BC * 4, "bits": plan.hbm_bytes,
            "vals": plan.vals.nbytes, "masks": plan.bits.nbytes,
            "pan_vptr": plan.pan.nbytes + plan.vptr.nbytes,
            "rowptr": plan.rowptr.nbytes}


def report_bcsr(name, A) -> None:
    b = bcsr_bytes(A)
    nnz = max(b["nnz"], 1)
    print(f"[{name}-bcsr] {b['nnz']} nnz, {b['tiles']} tiles, fill "
          f"{b['fill']:.4f} | dense tiles {b['dense']} B = "
          f"{b['dense'] / nnz:.2f} B/nnz | bits {b['bits']} B = "
          f"{b['bits'] / nnz:.2f} B/nnz (values {b['vals']}, masks "
          f"{b['masks']}, pan+vptr {b['pan_vptr']}, rowptr {b['rowptr']}) "
          f"| dense / bits {b['dense'] / max(b['bits'], 1):.2f}", flush=True)


def chips_bytes(plans, n: int) -> dict:
    """The chip slots of ``plans`` (single or split, one per shard), the
    entries they hold and both x sides' bytes: the slot products' and the
    two gather stages'."""
    parts = [s for p in plans for s in chips_slots.slot_parts(p)]
    slots = sum(s.E8 for s in parts) * BC
    staged = [s for s in parts if getattr(s, "kind", "resident")
              != "windowed-x"]
    hot = sum(s.p1.size for s in staged)
    x1 = sum(s.n1p_blocks * getattr(s, "R", getattr(s, "r1", 0)) * BC
             for s in staged)
    x1 += sum(s.H_pad * BC for s in parts
              if getattr(s, "kind", None) == "windowed-x")
    return {"slots": slots, "entries": int(sum(s.live.sum() for s in parts)),
            "slot_bytes": slots * 12,
            "hot_bytes": slots * 16 + hot * 8 + x1 * 4}


def report_chips(name, plans, n) -> None:
    b = chips_bytes(plans, n)
    e = max(b["entries"], 1)
    print(f"[{name}-chips] {len(plans)} plan(s), {b['slots']} chip slots "
          f"for {b['entries']} entries ({b['slots'] / e:.2f} slots/entry) | "
          f"slot products {b['slot_bytes']} B = {b['slot_bytes'] / e:.2f} "
          f"B/entry | two gather stages {b['hot_bytes']} B = "
          f"{b['hot_bytes'] / e:.2f} B/entry", flush=True)


def sharded_chips(A, n_shards: int) -> list:
    """The row-sharded hybrid's chips plans of ``A`` (default knobs)."""
    _, h_rows, _, _, cores = distributed.pack_shards(A, n_shards)
    return distributed._plan_sharded_chips(cores, h_rows, A.n)


def chips_reports() -> None:
    A = cases.amazon262k()
    report_chips("amazon262k", [lane_ell.pack_lane_ell(A).chips], A.n)
    W = cases.webbase1m()
    report_chips("dist-webbase1m", sharded_chips(W, 1), W.n)
    report_chips("dist-amazon262k-4x1", sharded_chips(A, 4), A.n)


def main(argv=()) -> int:
    if "chips" in argv:
        chips_reports()
        return 0
    if "bcsr" in argv:
        report_bcsr("flagship", cases.flagship())
        report_bcsr("stencil48k", cases.stencil48k())
        return 0
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
    report_bcsr("flagship", cases.flagship())
    report_bcsr("stencil48k", cases.stencil48k())
    chips_reports()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
