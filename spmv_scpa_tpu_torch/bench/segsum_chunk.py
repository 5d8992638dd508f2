"""The segment-sum kernel's chunk size C on the card.

    python -m spmv_scpa_tpu_torch.bench.segsum_chunk

``csrc/segsum.cu`` gives one warp to each chunk of at most C quanta of a
destination row block (``segsum_kernel.CHUNK``). This script takes the
segment-sum calls of five ``chip_smoke.py`` paths (``powerlaw100k-span``,
``flagship-bcsr``, ``amazon262k``, ``dist-webbase1m``,
``dist-amazon262k-4x1``), rebuilds their tables at each C of
:data:`CHUNKS`, holds the kernel bit-equal to the plain tree at that C
(``segsum_kernel.dest_plain``) and times it (device median,
``time_device``, summed over a path's calls), beside ``index_add_`` of
the same partials. Each path's line gives its live quanta, destinations
and the most quanta of one destination, then per C the chunks, hubs and
ms. Prints the card's ``nvidia-smi`` name and power limit first. Needs
the card and ``nvcc``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spmv_scpa_tpu_torch import get_strategy
from spmv_scpa_tpu_torch.bench import cases
from spmv_scpa_tpu_torch.bench.timing import time_device
from spmv_scpa_tpu_torch.ops import segsum_kernel as sk
from spmv_scpa_tpu_torch.parallel import distributed
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device
from spmv_scpa_tpu_torch.utils.vector import make_x

CHUNKS = (64, 128, 256, 512, 1024, 2048)
SEGSUMS = {"window_segsum": sk.window_segsum, "span_segsum": sk.span_segsum}


def paths(dev):
    """(name, matrix maker, prepare(A)) of each path."""
    hybrid = distributed.prepare_row_sharded_hybrid
    return [
        ("powerlaw100k-span", cases.powerlaw100k, lambda A: get_strategy(
            "cuda-pell").prepare(A, device=dev, scheme="span")),
        ("flagship-bcsr", cases.flagship, lambda A: get_strategy(
            "cuda-bcsr").prepare(A, device=dev, layout="tiles")),
        ("amazon262k", cases.amazon262k, lambda A: get_strategy(
            "cuda-hybrid").prepare(A, device=dev)),
        ("dist-webbase1m", cases.webbase1m, lambda A: hybrid(A, mesh=[dev])),
        ("dist-amazon262k-4x1", cases.amazon262k,
         lambda A: hybrid(A, idx8=True, mesh=[dev] * 4)),
    ]


def call_dest(name, args):
    """(partials, destination per quantum, destinations) of one call."""
    part, rbl, base, nw, h = args[:5]
    if name == "span_segsum":
        return part, sk.span_dest(rbl, base, h, args[5], nw), nw * h
    return part, sk.window_dest(rbl, base, h), nw * h


def median_ms(fn, *args) -> float:
    return float(np.median(time_device(fn, *args, reps=20)))


def index_add_ms(part, dest, n_dest) -> float:
    q = sk.quanta(part).contiguous()
    d = torch.where(dest >= 0, dest, n_dest)
    return median_ms(lambda: torch.zeros(n_dest + 1, 8, device=q.device)
                     .index_add_(0, d, q))


def main() -> int:
    if not torch.cuda.is_available():
        print("segsum_chunk: no CUDA device", file=sys.stderr)
        return 2
    dev = cuda_device()
    print(card_label(), flush=True)
    for path, make, prepare in paths(dev):
        A = make()
        prep = prepare(A)
        xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=dev)
        calls = [(k, a) for k, a in prep.kernel_calls(xd) if k in SEGSUMS]
        dests = [call_dest(k, a) for k, a in calls]
        live = sum(int((d >= 0).sum()) for _, d, _ in dests)
        most = max(int(torch.bincount(d[d >= 0], minlength=1).max())
                   for _, d, _ in dests)
        lib = sum(index_add_ms(*pd) for pd in dests)
        out = []
        for C in CHUNKS:
            ms, chunks, hubs = 0.0, 0, 0
            for (k, args), (part, dest, n_dest) in zip(calls, dests):
                tables = sk.dest_tables(dest, n_dest, dev, C)
                a = (*args[:-1], tables)
                y = SEGSUMS[k](*a)
                if not torch.equal(y, sk.dest_plain(part, dest, n_dest, C)):
                    raise AssertionError(f"{path}: {k} at C {C} differs "
                                         "from its plain tree")
                ms += median_ms(SEGSUMS[k], *a)
                chunks += tables.dest.numel()
                hubs += tables.hub.shape[0]
            out.append(f"C {C}: chunks {chunks} hubs {hubs} {ms:.4f} ms")
        print(f"[{path}] {len(calls)} calls, live quanta {live}, "
              f"destinations {sum(n for *_, n in dests)}, most on one "
              f"{most} | index_add_ {lib:.4f} ms | " + " | ".join(out),
              flush=True)
        del prep, calls, dests
    return 0


if __name__ == "__main__":
    sys.exit(main())
