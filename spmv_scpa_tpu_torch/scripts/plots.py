"""Aggregate and plot the benchmark CSVs (counterpart of
``scripts/plots.py``, copied; the reference study's scripts/plots.py).

Reads the three CSVs of the port's CLI and scripts (``serial.csv``,
``omp.csv``, ``cuda.csv``: the reference study's schemas,
``bench/logger.py``), takes medians over iterations (plots.py:21-53),
and renders:

* serial GFLOPS bars per format (plots.py:57-81),
* device GFLOPS bars per (format, chunk) with strategies as series
  (plots.py:92-115),
* best-strategy CSR-vs-HLL/PELL comparison (plots.py:117-136),
* avg GFLOPS vs chunk per nnz-bin per strategy (plots.py:139-183),
* host-parallel GFLOPS + speedup-vs-serial by nnz-bin
  (plots.py:195-207), and the row-shard sweep of ``scaling`` the same
  way (num_threads = shards).

NNZ bins follow the reference: [0,10K,100K,500K,1M,2.5M,10M,inf)
(plots.py:149-151). The ``kernel`` ids of ``cuda.csv`` are the JAX
package's (``bench/logger.REF_IDS``), so the legends name those
strategies. matplotlib and pandas are imported when a plot is drawn,
never when this module or the package is imported.

Run: ``python -m spmv_scpa_tpu_torch.scripts.plots -r res/``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from spmv_scpa_tpu_torch.bench.logger import REF_IDS

NNZ_BINS = [0, 10_000, 100_000, 500_000, 1_000_000, 2_500_000,
            10_000_000, np.inf]
NNZ_LABELS = ["<10K", "10K-100K", "100K-500K", "500K-1M", "1M-2.5M",
              "2.5M-10M", ">=10M"]

# id -> the JAX package's strategy name (inverse of its STRATEGY_IDS)
ID_TO_NAME = {v: k for k, v in REF_IDS.items()}


def _libs():
    """(matplotlib.pyplot on the Agg backend, pandas)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    return plt, pd


def _read(path):
    plt, pd = _libs()
    if not os.path.exists(path):
        return None
    df = pd.read_csv(path)
    return df if len(df) else None


def aggregate_serial(df):
    return df.groupby(["matrix", "format"], as_index=False).agg(
        duration_ms=("duration_ms", "median"),
        gflops=("gflops", "median"), nnz=("nnz", "first"))


def aggregate_device(df):
    return df.groupby(["matrix", "format", "kernel", "warps_per_block"],
                      as_index=False).agg(
        duration_ms=("duration_ms", "median"),
        gflops=("gflops", "median"), nnz=("nnz", "first"))


def aggregate_omp(df):
    return df.groupby(["matrix", "format", "bench", "num_threads"],
                      as_index=False).agg(
        duration_ms=("duration_ms", "median"),
        gflops=("gflops", "median"), nnz=("nnz", "first"))


def _bar_by_matrix(df, value, series, title, path):
    plt, pd = _libs()
    # collapse to one value per (matrix, series): best over other axes
    pivot = df.groupby(["matrix", series])[value].max().unstack(series)
    mats = list(pivot.index)
    series_vals = list(pivot.columns)
    w = 0.8 / max(len(series_vals), 1)
    fig, ax = plt.subplots(figsize=(max(8, len(mats) * 0.6), 4.5))
    xs = np.arange(len(mats))
    for i, sv in enumerate(series_vals):
        ys = pivot[sv].to_numpy(dtype=float)
        label = ID_TO_NAME.get(sv, str(sv)) if series == "kernel" else str(sv)
        ax.bar(xs + i * w, ys, w, label=label)
    ax.set_xticks(xs + 0.4 - w / 2)
    ax.set_xticklabels(mats, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("GFLOP/s")
    ax.set_title(title)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_serial(df, out):
    agg = aggregate_serial(df)
    _bar_by_matrix(agg, "gflops", "format", "Serial (host fp64) GFLOP/s",
                   os.path.join(out, "serial_gflops.png"))


def plot_device(df, out):
    plt, pd = _libs()
    agg = aggregate_device(df)
    for fmt in agg["format"].unique():
        sub = agg[agg["format"] == fmt]
        _bar_by_matrix(sub, "gflops", "kernel",
                       f"Device GFLOP/s — {fmt}",
                       os.path.join(out, f"device_{fmt}_gflops.png"))
    # best strategy per (matrix, format) — the cuda_best_csr_hll analog
    best = agg.loc[agg.groupby(["matrix", "format"])["gflops"].idxmax()]
    _bar_by_matrix(best, "gflops", "format",
                   "Best device strategy per format",
                   os.path.join(out, "device_best_by_format.png"))
    # chunk scaling per nnz-bin (warps_per_block analog, plots.py:139-183)
    agg = agg.assign(nnz_bin=pd.cut(agg["nnz"], NNZ_BINS,
                                    labels=NNZ_LABELS, right=False))
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for (k, b), sub in agg.groupby(["kernel", "nnz_bin"], observed=True):
        sub = sub[sub["warps_per_block"] > 0]
        if len(sub) < 2:
            continue
        s = sub.groupby("warps_per_block")["gflops"].mean()
        ax.plot(s.index, s.values, marker="o",
                label=f"{ID_TO_NAME.get(k, k)} [{b}]")
    ax.set_xlabel("chunk (tiles per grid step)")
    ax.set_ylabel("avg GFLOP/s")
    ax.set_title("Device chunk scaling by nnz bin")
    if ax.get_legend_handles_labels()[0]:
        ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(os.path.join(out, "device_chunk_scaling.png"), dpi=120)
    plt.close(fig)


def plot_device_per_bin(df, out):
    """Per-kernel figures: avg GFLOP/s vs chunk with nnz bins as series
    — the reference's per-bin per-kernel family (plots.py:139-183)."""
    plt, pd = _libs()
    agg = aggregate_device(df)
    agg = agg.assign(nnz_bin=pd.cut(agg["nnz"], NNZ_BINS,
                                    labels=NNZ_LABELS, right=False))
    for k, ksub in agg.groupby("kernel"):
        ksub = ksub[ksub["warps_per_block"] > 0]
        if ksub["warps_per_block"].nunique() < 2:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        for b, sub in ksub.groupby("nnz_bin", observed=True):
            s = sub.groupby("warps_per_block")["gflops"].mean()
            if len(s):
                ax.plot(s.index, s.values, marker="o", label=str(b))
        kname = ID_TO_NAME.get(k, str(k))
        ax.set_xlabel("chunk (tiles per grid step)")
        ax.set_ylabel("avg GFLOP/s")
        ax.set_title(f"{kname}: chunk scaling by nnz bin")
        ax.legend(fontsize=7, title="nnz bin")
        fig.tight_layout()
        fig.savefig(os.path.join(out, f"device_{kname}_per_bin.png"),
                    dpi=120)
        plt.close(fig)


def plot_omp_scaling(df, serial_df, out):
    """Parallel-scaling families per nnz bin — the reference's
    avg-GFLOPS-vs-threads and speedup-vs-threads plots
    (plots.py:186-248). num_threads = mesh device count for the
    distributed rows written by scripts/scaling.py."""
    plt, pd = _libs()
    agg = aggregate_omp(df)
    if agg["num_threads"].nunique() < 2:
        return
    agg = agg.assign(nnz_bin=pd.cut(agg["nnz"], NNZ_BINS,
                                    labels=NNZ_LABELS, right=False))
    for bench, bsub in agg.groupby("bench"):
        fig, ax = plt.subplots(figsize=(6, 4))
        for b, sub in bsub.groupby("nnz_bin", observed=True):
            s = sub.groupby("num_threads")["gflops"].mean()
            if len(s) >= 2:
                ax.plot(s.index, s.values, marker="o", label=str(b))
        ax.set_xlabel("devices in mesh")
        ax.set_ylabel("avg GFLOP/s")
        ax.set_title(f"{bench}: GFLOP/s vs parallelism by nnz bin")
        ax.legend(fontsize=7, title="nnz bin")
        fig.tight_layout()
        fig.savefig(os.path.join(out, f"omp_{bench}_gflops_by_bin.png"),
                    dpi=120)
        plt.close(fig)
    if serial_df is None:
        return
    ser = aggregate_serial(serial_df)
    ser = ser[ser["format"] == "CSR"].set_index("matrix")
    rows = []
    for _, r in agg.iterrows():
        if r["matrix"] in ser.index:
            rows.append({**r, "speedup":
                         float(ser.loc[r["matrix"], "duration_ms"])
                         / r["duration_ms"]})
    if not rows:
        return
    sp = pd.DataFrame(rows)
    for bench, bsub in sp.groupby("bench"):
        fig, ax = plt.subplots(figsize=(6, 4))
        for b, sub in bsub.groupby("nnz_bin", observed=True):
            s = sub.groupby("num_threads")["speedup"].mean()
            if len(s) >= 2:
                ax.plot(s.index, s.values, marker="o", label=str(b))
        ax.axhline(1.0, color="gray", lw=0.7, ls="--")
        ax.set_xlabel("devices in mesh")
        ax.set_ylabel("speedup vs serial CSR")
        ax.set_title(f"{bench}: speedup vs parallelism by nnz bin")
        ax.legend(fontsize=7, title="nnz bin")
        fig.tight_layout()
        fig.savefig(os.path.join(out, f"omp_{bench}_speedup_by_bin.png"),
                    dpi=120)
        plt.close(fig)


def plot_omp(df, serial_df, out):
    plt, pd = _libs()
    agg = aggregate_omp(df)
    _bar_by_matrix(agg, "gflops", "bench", "Host-parallel GFLOP/s",
                   os.path.join(out, "host_gflops.png"))
    if serial_df is None:
        return
    ser = aggregate_serial(serial_df).set_index(["matrix", "format"])
    rows = []
    for _, r in agg.iterrows():
        key = (r["matrix"], r["format"])
        if key in ser.index:
            rows.append({**r, "speedup":
                         ser.loc[key, "duration_ms"] / r["duration_ms"]})
    if rows:
        sp = pd.DataFrame(rows)
        _bar_by_matrix(sp, "speedup", "bench",
                       "Host-parallel speedup vs serial (plots.py:195-202)",
                       os.path.join(out, "host_speedup.png"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spmv_scpa_tpu_torch.scripts.plots",
        description="aggregate and plot the benchmark CSVs")
    ap.add_argument("-r", "--results", required=True,
                    help="dir containing serial.csv/omp.csv/cuda.csv")
    ap.add_argument("-o", "--out", default=None,
                    help="plot output dir (default: <results>/plots)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.results, "plots")
    os.makedirs(out, exist_ok=True)

    serial = _read(os.path.join(args.results, "serial.csv"))
    omp = _read(os.path.join(args.results, "omp.csv"))
    dev = _read(os.path.join(args.results, "cuda.csv"))

    if serial is not None:
        plot_serial(serial, out)
    if dev is not None:
        plot_device(dev, out)
        plot_device_per_bin(dev, out)
    if omp is not None:
        plot_omp(omp, serial, out)
        plot_omp_scaling(omp, serial, out)
    n = len(os.listdir(out))
    print(f"wrote {n} plots to {out}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
