"""CSV benchmark logger (counterpart of ``spmv_scpa_tpu/bench/logger.py``,
copied), schema-compatible with the reference study.

The reference appends to three files under the out dir, writing the
header only when the file is new and flushing after every row
(src/logger.c:19-72). Schemas (logger.c:31-40):

* ``serial.csv``: matrix,format,rows,cols,nnz,num_blocks,duration_ms,gflops
* ``omp.csv``:    matrix,format,bench,rows,cols,nnz,num_blocks,num_threads,duration_ms,gflops
* ``cuda.csv``:   matrix,format,kernel,warps_per_block,rows,cols,nnz,num_blocks,duration_ms,gflops

The files are byte for byte what the JAX package writes for the same
rows, so ``scripts/plots.py`` reads either. In ``cuda.csv``, ``kernel``
is the device strategy's id, the id of the JAX strategy it is held
against (``ref``): a port CSV and a JAX one share their ids;
``warps_per_block`` is the chunk sweep axis (the SpMM's columns, the
row shards' device count). ``num_blocks`` is empty where a layout has
none, as for CSR rows in the reference (logger.c:92-96).
"""

from __future__ import annotations

import os

# The JAX package's ids (its STRATEGY_IDS), by its strategy names; id 14
# is retired there and not reused.
REF_IDS = {
    "xla-csr-segsum": 0,
    "xla-ell-rm": 1,
    "xla-ell-cm": 2,
    "xla-dense": 3,
    "pallas-bcsr": 4,
    "pallas-pell": 5,
    "xla-ell-df64": 6,
    "pallas-bcsr-spmm": 7,
    "xla-csr-segsum-spmm": 8,
    "distributed-rowshard": 9,
    "pallas-pell-df64": 10,
    "pallas-hybrid": 11,
    "pallas-hybrid-df64": 12,
    "pallas-chips": 13,
    "pallas-xpose": 15,
    "pallas-nearfar": 16,
}

# The port's device strategies -> the id of their ``ref`` (the cuda.csv
# `kernel` column; the reference's kernel ids are 0..4 CSR / 0..3 HLL,
# main.c:259-263).
STRATEGY_IDS = {
    "torch-csr-segsum": REF_IDS["xla-csr-segsum"],
    "torch-ell-rm": REF_IDS["xla-ell-rm"],
    "torch-ell-cm": REF_IDS["xla-ell-cm"],
    "torch-dense": REF_IDS["xla-dense"],
    "cuda-bcsr": REF_IDS["pallas-bcsr"],
    "cuda-pell": REF_IDS["pallas-pell"],
    "torch-ell-fp64": REF_IDS["xla-ell-df64"],
    "cuda-bcsr-spmm": REF_IDS["pallas-bcsr-spmm"],
    "torch-csr-segsum-spmm": REF_IDS["xla-csr-segsum-spmm"],
    "distributed-rowshard": REF_IDS["distributed-rowshard"],
    "cuda-pell-fp64": REF_IDS["pallas-pell-df64"],
    "cuda-hybrid": REF_IDS["pallas-hybrid"],
    "cuda-hybrid-fp64": REF_IDS["pallas-hybrid-df64"],
    "cuda-chips": REF_IDS["pallas-chips"],
    "cuda-xpose": REF_IDS["pallas-xpose"],
    "cuda-nearfar": REF_IDS["pallas-nearfar"],
}

_HEADERS = {
    "serial": "matrix,format,rows,cols,nnz,num_blocks,duration_ms,gflops",
    "omp": ("matrix,format,bench,rows,cols,nnz,num_blocks,"
            "num_threads,duration_ms,gflops"),
    "cuda": ("matrix,format,kernel,warps_per_block,rows,cols,nnz,"
             "num_blocks,duration_ms,gflops"),
}


class CsvLogger:
    """Append-mode CSV logger with lazy headers (logger.c:19-51): an
    interrupted sweep keeps every row it completed."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self._files = {}
        for kind, header in _HEADERS.items():
            path = os.path.join(out_dir, f"{kind}.csv")
            existed = os.path.exists(path) and os.path.getsize(path) > 0
            f = open(path, "a")
            if not existed:
                f.write(header + "\n")
                f.flush()
            self._files[kind] = f

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def _blocks(num_blocks) -> str:
        return "" if num_blocks is None else str(int(num_blocks))

    def log_serial(self, *, matrix: str, fmt: str, rows: int, cols: int,
                   nnz: int, num_blocks, duration_ms: float, gflops: float):
        f = self._files["serial"]
        f.write(f"{matrix},{fmt},{rows},{cols},{nnz},"
                f"{self._blocks(num_blocks)},{duration_ms:f},{gflops:f}\n")
        f.flush()

    def log_omp(self, *, matrix: str, fmt: str, bench: str, rows: int,
                cols: int, nnz: int, num_blocks, num_threads: int,
                duration_ms: float, gflops: float):
        f = self._files["omp"]
        f.write(f"{matrix},{fmt},{bench},{rows},{cols},{nnz},"
                f"{self._blocks(num_blocks)},{num_threads},"
                f"{duration_ms:f},{gflops:f}\n")
        f.flush()

    def log_device(self, *, matrix: str, fmt: str, kernel, chunk: int,
                   rows: int, cols: int, nnz: int, num_blocks,
                   duration_ms: float, gflops: float):
        """A device-kernel row (the reference's log_*_cuda_benchmark,
        logger.c:131-152). ``kernel`` may be a strategy name or id."""
        if isinstance(kernel, str):
            kernel = STRATEGY_IDS.get(kernel, -1)
        f = self._files["cuda"]
        f.write(f"{matrix},{fmt},{kernel},{chunk},{rows},{cols},{nnz},"
                f"{self._blocks(num_blocks)},{duration_ms:f},{gflops:f}\n")
        f.flush()
