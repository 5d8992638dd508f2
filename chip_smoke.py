#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spmv_scpa_tpu_torch``) on one
NVIDIA card: ``python3 chip_smoke.py`` from the repository root.

Phases, each printing lines of its own numbers; any failure raises and
the script exits non-zero:

1. device: the card (nvidia-smi name and power limit), torch, nvcc;
2. build: nvcc builds every kernel from ``spmv_scpa_tpu_torch/csrc``,
   one process per source, all started together;
3. small cases: every matrix of ``bench/cases.py``'s ``SMALL_CASES``
   through ``cuda-hybrid`` on the card on both core layouts, the call
   against its plain version and the oracle, and each kernel call of the
   path replayed against its plain version; between them the cases must
   launch all eight kernels of the hybrid (``lane_rows``, the lanes core
   ``lane_ell_spmv`` with the ext route's gathers, the chips tail's
   ``chips_products``, ``window_segsum`` and ``heavy_land``, the direct
   landing);
4. the stream probe (``stream_reduce``, a TMA ring over contiguous
   spans) and the first port's grid-stride kernel
   (``stream_reduce_strided``) against their plain version (exact: sums
   of ones), each through ``measure_stream_bw`` with the counts set to 0
   just before and read just after, then both and ``sum`` in turns
   (probe, strided, sum, sum, strided, probe);
5. main path 1, the ML_Laplace stand-in (22.6M nnz), through
   ``cuda-hybrid``'s prepare on both core layouts from one pack
   (``lane_ell.prepare_hybrid_layouts``): the rows core (the default)
   validated, timed, given a roofline figure, and ``lane_rows`` and the
   probe must launch; then the lanes core's own run, which must launch
   ``lane_ell_spmv``; then the A/B of the two cores in turns (old, new,
   new, old), the core kernels alone and the whole calls, beside
   cuSPARSE of the core's entries and of the whole matrix and each
   layout's bound;
6. main path 2, ``amazon262k`` (the amazon0302 stand-in, 1M nnz),
   default knobs: the chips tail (and the ext route on the lanes core);
   the same two runs and A/B, each run validated, timed, each kernel
   alone at this matrix's shapes; the rows run also host enqueue against
   device time over 200 back-to-back calls and a profiler window; the
   core, the slot products, the segment-sum and ``heavy_land`` must
   launch in each run (the lanes run: both ext gathers too), and no
   gather in the rows run; then the chips A/B (the x side on the two
   gather stages against the slot products) and the landing A/B
   (``landing="merge"``, the reference's segment-sum per stream and
   panel merge, against the default direct landing, one segment-sum and
   ``heavy_land``, from one pack in turns: those kernels alone, the
   whole calls, host enqueue against device time over 200 calls, port
   kernel calls a call, ``heavy_land`` beside its bound and
   ``index_add_``);
7. main path 3, ``ext_windowed1m`` (1M rows, 5M nnz), default knobs:
   the same; the lanes run takes the windowed stage 2, and the windowed
   gather must launch there;
8. small PELL cases: every matrix of ``bench/cases.py``'s
   ``PELL_CASES`` through ``cuda-pell`` or ``cuda-bcsr`` at its default
   layout, the fused and BCSR ones again on ``layout="tiles"``, and
   ``BITS_CASES`` through ``cuda-bcsr``, checked as the small hybrid
   cases are; between them they must launch the row kernel, the fused
   kernel, the tile kernel, both segment-sums, the un-permute and
   ``bcsr_bits``;
9. main path 4, ``powerlaw100k`` (100k rows, about 11M nnz) through
   ``cuda-hybrid`` at default knobs: the no-locality escape to
   ``cuda-pell`` on the row layout; validated, timed, each kernel
   alone, host against device over 200 calls; ``pell_rows`` must
   launch; then the A/B: the tile layout's fused kernel (``cuda-pell``,
   ``layout="tiles"``) against ``pell_rows`` in turns (old, new, new,
   old), and the two whole calls so, beside cuSPARSE and the bounds;
10. main path 5, ``webbase1m`` (the webbase-1M stand-in) through
   ``cuda-hybrid`` at default knobs: the core and a tail past
   ``BIG_TAIL`` run as compact PELL on the row layout, landed by
   ``heavy_land``; the same two core runs and A/B as path 2, and the
   landing A/B; the core, ``pell_rows`` and ``heavy_land`` must launch,
   and no gather in the rows run;
   then the A/B of the tail's two kernels (the hybrid with
   ``pell_layout="tiles"``);
11. ``powerlaw100k`` through ``cuda-pell`` with ``scheme="span"``: the
   tile kernel and the span segment-sum at full size;
12. main path 18, ``flagship-bcsr``: the flagship through ``cuda-bcsr``
   on the bitmap tiles, timed; ``bcsr_bits`` must launch and neither
   the tile kernel nor the window segment-sum; then
   ``flagship-bcsr-tiles`` (``layout="tiles"``), which must launch
   those two, and the A/B of the two layouts in turns (old, new, new,
   old), the kernels alone and the whole calls, beside cuSPARSE of A;
13. small XPOSE cases: every matrix of ``bench/cases.py``'s
   ``XPOSE_CASES`` through ``cuda-xpose``, and the hybrid with an XPOSE
   big tail (``XPOSE_TAIL``), each on the default design, on
   ``s1="slab"`` and on ``s3="prefix"``, checked as the small hybrid
   cases are; between them they must launch the slot-table S1, the
   mirror, the slab S1 and both S3 kernels;
14. main path 6, ``webbase1m`` through ``spmv``'s auto route:
   ``pick_auto`` must choose ``cuda-xpose`` and its planner must accept
   the matrix (a refusal fails, printing the reason, instead of falling
   back); ``spmv(A, x)`` must launch the two XPOSE kernels of the
   default design (S1 over the slot table, ``xpose_s1_slots``; S3 as
   row sums, ``xpose_s3_rows``) and no other; validated, timed, each
   kernel alone, host against device over 200 calls, a profiler window,
   cuSPARSE of the whole matrix; the pack line gives the plan's, the S3
   row table's and the S1 slot table's build times alone; then the same plan on
   ``s1="slab"`` (``webbase1m-xpose-slab``), which must launch the
   mirror and ``xpose_s1`` and not the slot kernel, and the S1 A/B: the
   slab pair (mirror and ``xpose_s1`` back to back) against the slot
   kernel alone in turns (old, new, new, old), the whole calls the same
   way (their y equal), the yardstick and both bounds (``S1 A/B``
   lines); then the plan on ``s3="prefix"`` (``webbase1m-xpose-prefix``),
   which must launch ``xpose_s3`` and neither the row sums nor the slot
   kernel, and the S3 A/B the same way (``S3 A/B`` lines);
15. main path 7, ``random30k`` (uniform scatter) the same way;
16. main path 8, ``amazon262k`` through ``cuda-nearfar``: the band
   through the hybrid, the scattered rest through XPOSE; the core and
   the two XPOSE kernels must launch, neither the mirror nor the slab
   S1; then ``s1="slab"``, ``s3="prefix"`` and the two A/Bs as path 6;
17. small fp64 and SpMM cases: ``bench/cases.py``'s ``FP64_CASES``
   (``cuda-hybrid-fp64``, ``cuda-pell-fp64`` on both layouts) and
   ``SPMM_CASES`` (``cuda-bcsr-spmm`` at 1, 8 and 64 columns, on both
   layouts), checked as the small hybrid cases are; between them they
   must launch ``lane_ell_fp64``, ``pell_rows_fp64``, ``pell_fused_fp64``,
   ``bcsr_spmm`` and ``bcsr_bits_spmm``;
18. main path 9, ``flagship-fp64``: the flagship through
   ``cuda-hybrid-fp64`` (x and y float64); ``lane_ell_fp64`` must
   launch; beside it the ``torch-ell-fp64`` baseline and cuSPARSE's fp64
   CSR product of the same matrix;
19. main path 10, ``powerlaw100k-fp64``: ``powerlaw100k`` through
   ``cuda-pell-fp64`` (the row layout); ``pell_rows_fp64`` must launch;
   then ``powerlaw100k-fp64-tiles`` (``layout="tiles"``), which must
   launch ``pell_fused_fp64``, and the A/B of the two kernels in turns;
20. main path 11, ``flagship-spmm8``: the flagship through
   ``cuda-bcsr-spmm`` with X of 8 columns on the bitmap tiles;
   ``bcsr_bits_spmm`` must launch and ``bcsr_spmm`` not; then
   ``flagship-spmm8-tiles``, which must launch ``bcsr_spmm``, and the
   A/B as path 18;
21. main path 12, ``stencil48k-spmm64``: ``cases.stencil48k()`` (the
   flagship's stencil at 48,000 rows, whose X of 64 columns fits the
   reference's X budget) through ``cuda-bcsr-spmm`` at 64 columns, the
   same two runs and A/B;
22. small row-sharded cases: ``bench/cases.py``'s ``DIST_CASES`` (the six
   routes of ``__graft_entry__.dryrun_multichip``) at 2 and 4 shards on
   one card, the hybrid routes on both core layouts (at 2 shards without
   the two chips routes, which both packages refuse there: those shards
   have no tail), ``amazon40k`` with ext panels (lanes core) and
   ``powerlaw1200`` through the row-sorted PELL at 4 shards, each call
   against its plain call and the oracle and each kernel call replayed;
   between them they must launch ``lane_ell_sharded``, ``lane_rows``,
   the three gathers, ``window_segsum``, ``pell_fused`` and
   ``pell_unpermute``; then ``cuda-chips`` on its small cases and
   ``heavy_scatter`` through ``cuda-hybrid`` (the split chips plan),
   which must launch the slot products, the segment-sum and
   ``heavy_land`` (on ``chips_x="hot"``: the gathers, the segment-sum
   and ``heavy_land``);
23. main path 13, ``dist-flagship``: the flagship through the row-sharded
   hybrid on the mesh ``[cuda:0]`` (``loc_w`` 256, chunk 24), both core
   layouts from one pack (``row_sharded_hybrid_layouts``), the two runs
   and the A/B as path 2 (``lane_rows`` and ``lane_ell_sharded`` must
   launch), beside ``cuda-hybrid`` with the same knobs: the gap between
   the two rows-core calls is what the distributed wrapper costs;
24. main path 14, ``dist-flagship-4x1``: the rows core on ``["cuda:0"] *
   4``, one ``lane_rows`` launch per call;
25. main path 15, ``dist-webbase1m``: ``webbase1m`` at mesh 1, whose tail
   must take the ``chips-split`` route (the split streams' slot
   products, one segment-sum and ``heavy_land``, no gather), the two runs
   and the core, chips and landing A/Bs; one call launches the slot
   products, the segment-sum and ``heavy_land`` once each (four port
   kernel calls);
26. main path 16, ``dist-amazon262k-4x1``: ``amazon262k`` on four shards
   of one card with ``idx8``: the shards' chips tails (the reference's
   meta picks the panel merge; the default lands them directly), the
   ext panels on the lanes core, the two runs and the core, chips and
   landing A/Bs; one call launches ``lane_rows``, the slot products, the
   segment-sum and ``heavy_land`` once each for the four shards (four
   port kernel calls);
27. main path 17, ``dist-powerlaw100k-pell``: ``powerlaw100k`` through
   ``prepare_row_sharded_pell`` at mesh 1 (the tile layout): the fused
   kernel and the un-permute;
28. main path 19, ``banded3m3`` (3.3M rows, 12M nnz, x 13.2 MB: past
   the reference's 12 MB x budget) through ``spmv``'s route:
   ``pick_auto`` must give ``cuda-pell``, on the row layout with no
   stripe, one ``pell_rows`` launch a call and no fused kernel;
   validated, timed, each kernel alone beside cuSPARSE of the matrix;
   then ``banded3m3-tiles`` (``layout="tiles"``), the reference's three
   column stripes, three ``pell_fused`` launches a call, and the A/B of
   the two layouts in turns;
29. ``powerlaw100k-hot``: the tiles with 2,048 hot columns, each kernel
   replayed, its fill beside the tiles' without the remap;
30. ``webbase1m-bcsr``: ``webbase1m`` through ``cuda-hybrid`` with its
   big tail through ``pallas-bcsr`` (compact, the bitmap tiles, landed
   by ``heavy_land``): ``lane_rows``, ``bcsr_bits`` and ``heavy_land``
   must launch, no gather and no ``pell_rows``; then the tail A/B in
   turns against the default compact-PELL tail (the tails' kernels
   alone, the whole calls);
31. small column and tail cases: ``bench/cases.py``'s ``COLUMN_CASES``
   (three stripes, the padded boundary, hot columns, the shifted grid)
   through ``cuda-pell`` on the tiles and on the rows, and the hybrid
   with ``cases.BIG_TAIL``'s tail through each reference name that runs
   (``lane_ell.COMPACT_TAILS``), checked as the small hybrid cases are;
32. the port's CLI as its users run it (``cli.run`` in process,
   ``cli_phase``): (a) ``amazon262k`` written as a ``.mtx``, read by the
   native parser into the layout cache, with ``-d --chunks 64
   --distributed --spmm-cols 8 --host-parallel`` and ``-b`` every torch
   and cuda SpMV strategy; ``lane_rows``, ``chips_products``,
   ``window_segsum`` and ``pell_rows`` must launch; the same command
   again must read the cache without a parse and append under the
   single headers; then the runner's ``cuda-hybrid`` row beside path 2's
   call time; (b) the ``stencil48k`` spec through ``cuda-hybrid``,
   ``cuda-hybrid-fp64`` and ``cuda-bcsr`` with the SpMM at 8 and 64
   columns; ``bcsr_bits``, ``bcsr_bits_spmm`` and ``lane_ell_fp64`` must
   launch. Each run must exit 0, every row must have passed ``-d``,
   every skipped cell must be a refusal (printed with its reason), the
   CSVs carry the reference's headers and the JAX package's kernel ids;
33. the script harness (``scripts_phase``): ``scripts.results`` on the
   synthetic suite's first spec with ``-i 2 --debug``, then
   ``scripts.scaling`` on the scaling suite's first matrix at 1 and 4
   shards of the card (``--pell --hybrid``), every row validated, their
   CSVs' rows and ids checked; ``lane_rows`` and ``pell_rows`` must
   launch in each.

Each path sets the launch counts to 0 just before it and reads them
just after; replays that hold a kernel against its plain version come
after the read; a profiler window counts only where it saw every launch
(``device_busy``), else its line says that events were lost and gives
no idle share; a path on both core layouts reads the lanes run apart
(its counts set to 0 just before it). Each prints its packing time.
Then one JSON line of the twenty-seven kernels' numbers, thirty-two
lines (``pell_rows`` also on ``dist-powerlaw100k-pell`` and
``banded3m3``, ``pell_fused`` also on ``banded3m3-tiles``, ``bcsr_bits``
and ``heavy_land`` also on ``webbase1m-bcsr``; ``lane_ell_spmv``,
``lane_ell_sharded`` and ``window_gather`` from the lanes runs of the
flagship, ``dist-flagship`` and ``ext_windowed1m``, ``bcsr_spmm`` from
``flagship-spmm8-tiles``, ``xpose_mirror`` and ``xpose_s1`` from
``webbase1m-xpose-slab``, ``xpose_s3`` from ``webbase1m-xpose-prefix``,
``stream_reduce_strided`` from its ``measure_stream_bw`` run), the card
line, and
the contract line ``{"ok":
true, "device": {...}}`` last. Without a card it prints no result and
exits 2.

Tolerances: the whole call against its plain call, rel-L2 <= 1e-6 and
per row |dy| <= 1e-5 * (|A||x|)_row: the core, the gathers, the tile
kernel, the segment-sums and the un-permute are bit-equal to their plain
versions, while the plain fused kernel and the compact tail's
``index_add_`` add with atomics in a varying order on the card. Each
kernel call replayed alone: the core, the gathers, the tile kernel, the
un-permute and XPOSE's mirror, S1 and prefix S3 bit-equal to their
plain versions, and so is the row-shard core ``lane_ell_sharded``; the
segment-sums, the fused kernel, the row kernel and the rows core
``lane_rows`` bit-equal to their plain versions run on the CPU (the same
fixed order) and within rel-L2 1e-6 of the plain versions on the card (1e-12 at fp64; the segment-sums'
plain versions add in the kernel's order there too, so their max|d| is
0). Against ``spmv_oracle``: ``validate_result`` (rel 1e-4). The fp64
paths (x and y float64): against the oracle at relative L2 <= 1e-9 with
the absolute gate off (``abs_l2=0``: the reference's 0.1 at ||y|| >= 1
would pass an f32-grade y); ``lane_ell_fp64`` bit-equal to its plain
version; ``pell_fused_fp64`` and ``pell_rows_fp64`` bit-equal to their
plain versions run on the CPU; a whole fp64 call within rel-L2 1e-12 of its plain call (the plain
fused kernel adds windows with atomics on the card). SpMM:
``bcsr_spmm`` bit-equal to its plain version (both add each row's tiles
and lanes in order, f32 products and sums rounded separately, no TF32);
Y against ``spmm_oracle`` by ``validate_result``. The bitmap kernels
``bcsr_bits`` and ``bcsr_bits_spmm``, XPOSE's row sums
``xpose_s3_rows``, its slot-table S1 ``xpose_s1_slots``, the chips
tail's ``chips_products`` and the direct landing ``heavy_land`` (each
replay on its own copy of y, which it updates in place), bit-equal to
their plain versions on the card and run on the CPU (a fixed order, no
atomics; the slot kernel at the slots of mid its table names, the only
ones it writes). The slot and slab S1 designs' whole calls give equal y
on the full-size XPOSE paths.

``bound_ms`` is the least time for the same work on an H100 SXM: the
bytes of every input read once and every output written once over 3.35
TB/s, or the f32 operations over 67 TFLOP/s (f64 over 34 TFLOP/s),
whichever is larger (bytes bound every kernel here). The SpMM counts
the multiply-adds of its tiles' nonzero values only, not those of the
stored zeros. Where the
data decides what is read, only that counts: a gather's distinct in-
range source elements, the segment-sums' partials that land in y, the
distinct x elements the tile, fused and row kernels and ``lane_rows``
read, the distinct x elements (or rows of X) the bitmap kernels' stored
slots name, beside all their arrays (2 x stored x cols operations), the
mirror's
distinct source rows, S1's distinct x elements (of its entries; the
slot kernel: its table, the slots it writes and the distinct x elements
its nonzero entries read), S3's
distinct product elements (the row sums: beside their table and y), the
slot products' distinct x elements (beside their columns, values and
products, 12 B a slot) and the SpMM's distinct rows of X. Beside a
row kernel's bound (its layout's bytes) the lines print its format-free
bound: its entries at one value and one 4-byte column each, x and y,
over 3.35 TB/s. Kernel and
library times are device times (``bench.timing.time_device``: the host's
enqueue does not enter them); a plain version and a whole call are timed
as their caller sees them (event pairs,
``time_cuda``/``time_prepared``). ``library_ms`` times one PyTorch call
computing the same function: a cuSPARSE CSR product for the lanes core
(of the whole matrix), for ``lane_rows`` (of the core's own entries; the
A/B lines print the whole matrix's beside it), for the fused kernel (of the matrix its tiles hold), the row kernels
(of the matrix their slots hold, in their dtype) and
for the tile kernel (of a matrix with one row per tile row and quantum,
whose product is the partials; for S1, of a matrix with one row per
product slot holding its one entry, whose product is S1's product
array; for the slot kernel, one row per slot of mid over x itself),
``sum`` for the probe, flat indexing for a gather, the un-
permute and the mirror, ``x_pad[cols]`` for the slot products (the
gather alone, without the multiply), ``index_add_`` for the
segment-sums and ``heavy_land`` (the same sums into the same rows) and,
after a flat gather of the routed products, for both S3 kernels;
cuSPARSE's fp64 CSR product
for the fp64 core (of the whole matrix) and the fp64 fused kernel (of
the matrix its tiles hold), and its f32 CSR SpMM ``A @ X`` for the SpMM
kernel; for the bitmap kernels, its f32 CSR SpMV or SpMM of the matrix
their tiles hold (A with duplicates summed). The port never calls these
yardsticks.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from spmv_scpa_tpu_torch import _kernels, cli, get_strategy, list_strategies
from spmv_scpa_tpu_torch import spmv
from spmv_scpa_tpu_torch import testing as synth
from spmv_scpa_tpu_torch.bench import cases, logger, roofline as roof
from spmv_scpa_tpu_torch.bench.runner import REFUSALS
from spmv_scpa_tpu_torch.bench.timing import (time_cuda, time_device,
                                              time_prepared)
from spmv_scpa_tpu_torch.formats.csr import BC, CSR
from spmv_scpa_tpu_torch.io import cache, mmio, native
from spmv_scpa_tpu_torch.ops import (bcsr_bits, chips_slots, chips_tail,
                                     ext_gather, lane_ell, lane_ell_fp64,
                                     lane_rows, native_omp, pell, pell_rows,
                                     segsum_kernel, spmm, xpose, xpose_plan)
from spmv_scpa_tpu_torch.ops.oracle import spmm_oracle, spmv_oracle
from spmv_scpa_tpu_torch.ops.registry import FP64_RTOL, pick_auto, to_numpy
from spmv_scpa_tpu_torch.parallel import distributed
from spmv_scpa_tpu_torch.scripts import results, scaling
from spmv_scpa_tpu_torch.utils.platform import card_label, cuda_device
from spmv_scpa_tpu_torch.utils.validation import validate_result
from spmv_scpa_tpu_torch.utils.vector import make_x

TWIN_REL_L2 = 1e-6
TWIN_ROW_REL = 1e-5
FP64_TWIN = 1e-12                  # an fp64 call against its plain call
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
F64_OPS_PER_S = 34e12              # f64 outside the tensor cores

HYBRID_KERNELS = ("lane_ell_spmv", "lane_rows", "sorted_gather",
                  "ranked_gather", "window_gather", "window_segsum",
                  "chips_products", "heavy_land")
PELL_KERNELS = ("pell_fused", "pell_tiles", "span_segsum", "window_segsum",
                "unpermute", "pell_rows", "bcsr_bits")
XPOSE_KERNELS = ("xpose_s1_slots", "xpose_s3_rows")
# S1 on the slab (s1="slab": the reference's design carried over), and
# both stages so (s3="prefix")
SLAB_KERNELS = ("xpose_mirror", "xpose_s1", "xpose_s3_rows")
PREFIX_KERNELS = ("xpose_mirror", "xpose_s1", "xpose_s3")
# the XPOSE designs each full-size XPOSE path runs, from one plan: the
# default, S1 on the slab, both stages as the reference's
DESIGNS = ("rows", ("rows", "slab"), "prefix")
FP64_SPMM_KERNELS = ("lane_ell_fp64", "pell_fused_fp64", "bcsr_spmm",
                     "pell_rows_fp64", "bcsr_bits_spmm")
DIST_KERNELS = ("lane_ell_sharded", "lane_rows", "sorted_gather",
                "ranked_gather", "window_gather", "window_segsum",
                "chips_products", "heavy_land", "pell_fused", "unpermute",
                "pell_rows")
# one call of the row-sharded hybrid with chips tails, on the rows core:
# one launch each for all the shards of the card
DIST_CALL = ("lane_rows", "chips_products", "window_segsum", "heavy_land")
# the core kernels of the two layouts: the lanes core's single-card and
# row-shard kernels, and the rows core's one kernel
CORE_KERNELS = ("lane_ell_spmv", "lane_ell_sharded", "lane_rows")
# the chips tail on its default x side (the slot products) and landing
# (one segment-sum, the direct scatter), and on chips_x="hot" (the two
# gather stages)
CHIPS_KERNELS = ("chips_products", "window_segsum", "heavy_land")
CHIPS_HOT_KERNELS = ("sorted_gather", "ranked_gather", "window_gather",
                     "window_segsum", "heavy_land")
GATHERS = ("sorted_gather", "ranked_gather", "window_gather")
# kernels held bit-equal to their plain versions run on the CPU (the same
# fixed order); on the card the fused and row kernels' plain versions add
# with index_add_ (atomics), the segment-sums' in the kernel's order
ORDERED = ("window_segsum", "span_segsum", "pell_fused", "pell_fused_fp64",
           "pell_rows", "pell_rows_fp64", "lane_rows")
# kernels held bit-equal to their plain versions on the card and run on the
# CPU alike (the plain versions add in the kernels' order without atomics)
EXACT_BOTH = ("bcsr_bits", "bcsr_bits_spmm", "xpose_s1_slots",
              "xpose_s3_rows", "chips_products", "heavy_land")
# kernels that update their first argument in place: a replay gives each
# call its own copy of it
INPLACE = ("heavy_land",)
# every kernel and its plain version, by name
KERNELS = {**lane_ell.KERNELS._asdict(), **lane_ell_fp64.KERNELS._asdict(),
           **pell.FP64_KERNELS._asdict(), **spmm.KERNELS._asdict(),
           **distributed.KERNELS._asdict()}
PLAIN = {**lane_ell.PLAIN._asdict(), **lane_ell_fp64.PLAIN._asdict(),
         **pell.FP64_PLAIN._asdict(), **spmm.PLAIN._asdict(),
         **distributed.PLAIN._asdict()}
SOURCES = {
    "lane_ell_spmv": ("spmv_scpa_tpu_torch/csrc/lane_ell.cu",
                      "spmv_scpa_tpu/ops/lane_ell.py:188"),
    "lane_ell_sharded": ("spmv_scpa_tpu_torch/csrc/lane_ell.cu",
                         "spmv_scpa_tpu/parallel/distributed.py:480"),
    # the same body launched per row shard (distributed.py:480) too
    "lane_rows": ("spmv_scpa_tpu_torch/csrc/lane_rows.cu",
                  "spmv_scpa_tpu/ops/lane_ell.py:188"),
    "stream_reduce": ("spmv_scpa_tpu_torch/csrc/stream_probe.cu",
                      "spmv_scpa_tpu/bench/roofline.py:60"),
    "stream_reduce_strided": ("spmv_scpa_tpu_torch/csrc/stream_probe.cu",
                              "spmv_scpa_tpu/bench/roofline.py:60"),
    "sorted_gather": ("spmv_scpa_tpu_torch/csrc/ext_gather.cu",
                      "spmv_scpa_tpu/ops/ext_gather.py:79"),
    "ranked_gather": ("spmv_scpa_tpu_torch/csrc/ext_gather.cu",
                      "spmv_scpa_tpu/ops/ext_gather.py:121"),
    "window_gather": ("spmv_scpa_tpu_torch/csrc/ext_gather.cu",
                      "spmv_scpa_tpu/ops/ext_gather.py:167"),
    # stage 1 (ext_gather.py:79), stage 2 (:121 and :167) and the
    # multiply on the chips tail's path, as one kernel
    "chips_products": ("spmv_scpa_tpu_torch/csrc/chips_products.cu",
                       "spmv_scpa_tpu/ops/ext_gather.py:79"),
    # the landing's panel merge: the ranked gather (ext_gather.py:121; the
    # windowed one, :167) over every row of y, as a direct scatter
    "heavy_land": ("spmv_scpa_tpu_torch/csrc/heavy_land.cu",
                   "spmv_scpa_tpu/ops/ext_gather.py:121"),
    "window_segsum": ("spmv_scpa_tpu_torch/csrc/segsum.cu",
                      "spmv_scpa_tpu/ops/segsum_kernel.py:259"),
    "pell_fused": ("spmv_scpa_tpu_torch/csrc/pell.cu",
                   "spmv_scpa_tpu/ops/pallas_kernels.py:419"),
    "pell_tiles": ("spmv_scpa_tpu_torch/csrc/pell.cu",
                   "spmv_scpa_tpu/ops/pallas_kernels.py:64"),
    "span_segsum": ("spmv_scpa_tpu_torch/csrc/segsum.cu",
                    "spmv_scpa_tpu/ops/segsum_kernel.py:120"),
    "unpermute": ("spmv_scpa_tpu_torch/csrc/pell.cu",
                  "spmv_scpa_tpu/ops/pallas_kernels.py:1518"),
    "xpose_mirror": ("spmv_scpa_tpu_torch/csrc/xpose.cu",
                     "spmv_scpa_tpu/ops/xpose.py:137"),
    "xpose_s1": ("spmv_scpa_tpu_torch/csrc/xpose.cu",
                 "spmv_scpa_tpu/ops/xpose.py:62"),
    # the mirror (xpose.py:137) folded into its table too
    "xpose_s1_slots": ("spmv_scpa_tpu_torch/csrc/xpose.cu",
                       "spmv_scpa_tpu/ops/xpose.py:62"),
    "xpose_s3": ("spmv_scpa_tpu_torch/csrc/xpose.cu",
                 "spmv_scpa_tpu/ops/xpose.py:87"),
    "xpose_s3_rows": ("spmv_scpa_tpu_torch/csrc/xpose.cu",
                      "spmv_scpa_tpu/ops/xpose.py:87"),
    "lane_ell_fp64": ("spmv_scpa_tpu_torch/csrc/lane_ell.cu",
                      "spmv_scpa_tpu/ops/lane_ell.py:282"),
    "pell_fused_fp64": ("spmv_scpa_tpu_torch/csrc/pell.cu",
                        "spmv_scpa_tpu/ops/pallas_kernels.py:761"),
    "bcsr_spmm": ("spmv_scpa_tpu_torch/csrc/spmm.cu",
                  "spmv_scpa_tpu/ops/pallas_kernels.py:1076"),
    "pell_rows": ("spmv_scpa_tpu_torch/csrc/pell_rows.cu",
                  "spmv_scpa_tpu/ops/pallas_kernels.py:419"),
    "pell_rows_fp64": ("spmv_scpa_tpu_torch/csrc/pell_rows.cu",
                       "spmv_scpa_tpu/ops/pallas_kernels.py:761"),
    "bcsr_bits": ("spmv_scpa_tpu_torch/csrc/bcsr_bits.cu",
                  "spmv_scpa_tpu/ops/pallas_kernels.py:64"),
    "bcsr_bits_spmm": ("spmv_scpa_tpu_torch/csrc/bcsr_bits.cu",
                       "spmv_scpa_tpu/ops/pallas_kernels.py:1076"),
}
# the kernels line, in order; pell_rows twice: single-card powerlaw100k
# and the row-sharded dist-powerlaw100k-pell; then the column branches'
# and the BCSR big tail's lines: pell_rows on banded3m3, pell_fused as
# its three stripes, bcsr_bits and heavy_land on webbase1m-bcsr
LINE_ORDER = ("lane_ell_spmv", "lane_ell_sharded", "lane_rows",
              "stream_reduce", "stream_reduce_strided", "sorted_gather",
              "ranked_gather", "window_gather", "chips_products",
              "window_segsum", "heavy_land",
              "pell_fused", "pell_tiles", "span_segsum", "unpermute",
              "xpose_mirror", "xpose_s1", "xpose_s1_slots", "xpose_s3",
              "xpose_s3_rows",
              "lane_ell_fp64",
              "pell_fused_fp64", "bcsr_spmm", "pell_rows", "pell_rows",
              "pell_rows_fp64", "bcsr_bits", "bcsr_bits_spmm",
              "pell_rows", "pell_fused", "bcsr_bits", "heavy_land")


# ---- launch counts -----------------------------------------------------------

def counts() -> dict:
    return {"lane_ell_spmv": lane_ell.KERNEL_LAUNCHES,
            "lane_ell_sharded": lane_ell.SHARDED_LAUNCHES,
            "stream_reduce": roof.KERNEL_LAUNCHES,
            "stream_reduce_strided": roof.STRIDED_LAUNCHES,
            **ext_gather.LAUNCHES,
            **chips_slots.LAUNCHES,
            **chips_tail.LAUNCHES,
            "window_segsum": segsum_kernel.KERNEL_LAUNCHES,
            **pell.LAUNCHES,
            **pell_rows.LAUNCHES,
            **lane_rows.LAUNCHES,
            "span_segsum": segsum_kernel.SPAN_LAUNCHES,
            **xpose.LAUNCHES,
            "lane_ell_fp64": lane_ell_fp64.KERNEL_LAUNCHES,
            "bcsr_spmm": spmm.KERNEL_LAUNCHES,
            **bcsr_bits.LAUNCHES}


def reset_counts() -> None:
    lane_ell.KERNEL_LAUNCHES = 0
    lane_ell.SHARDED_LAUNCHES = 0
    lane_ell_fp64.KERNEL_LAUNCHES = 0
    spmm.KERNEL_LAUNCHES = 0
    roof.KERNEL_LAUNCHES = 0
    roof.STRIDED_LAUNCHES = 0
    segsum_kernel.KERNEL_LAUNCHES = 0
    segsum_kernel.SPAN_LAUNCHES = 0
    for table in (ext_gather.LAUNCHES, chips_slots.LAUNCHES,
                  chips_tail.LAUNCHES, pell.LAUNCHES, pell_rows.LAUNCHES,
                  lane_rows.LAUNCHES, xpose.LAUNCHES, bcsr_bits.LAUNCHES):
        for k in table:
            table[k] = 0


def require(launched: dict, names, what: str, forbid=()) -> None:
    """Each of ``names`` launched at least once, none of ``forbid``."""
    missing = [k for k in names if launched.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing} "
                             f"(counts {launched})")
    ran = [k for k in forbid if launched.get(k, 0)]
    if ran:
        raise AssertionError(f"{what}: kernels launched that this path must "
                             f"not run: {ran} (counts {launched})")


# ---- checks and timing ---------------------------------------------------------

def twin_check(A, x, yk, yt, what, rel_tol=TWIN_REL_L2,
               row_tol=TWIN_ROW_REL):
    """Kernel y (or Y) against plain y within the stated tolerances."""
    yk = yk.double().cpu().numpy()
    yt = yt.double().cpu().numpy()
    d = np.abs(yk - yt)
    rel_l2 = float(np.linalg.norm(d) / max(np.linalg.norm(yt), 1e-300))
    absA = CSR(A.name, A.m, A.n, A.irp, A.ja, np.abs(A.as_))
    scale = spmm_oracle(absA, np.abs(x))
    row_rel = float(np.max(d / np.maximum(scale, 1e-300), initial=0.0))
    if not (rel_l2 <= rel_tol and row_rel <= row_tol):
        raise AssertionError(
            f"{what}: kernel vs plain rel-L2 {rel_l2:.3e} (<= "
            f"{rel_tol:g}), row rel {row_rel:.3e} (<= {row_tol:g})")
    return rel_l2, row_rel, float(d.max(initial=0.0))


def path_input(A, strategy, knobs, dev):
    """What a path feeds a strategy and holds it to: (x as numpy, x on
    the card, the oracle's y, ``validate_result``'s keywords,
    ``twin_check``'s). The fp64 grade takes and returns float64, gated at
    rel 1e-9 with the absolute gate off; an SpMM-only strategy takes X
    (n, cols) with ``spmm_oracle`` as its oracle."""
    if strategy in list_strategies() and get_strategy(strategy).spmm_only:
        x = make_x(A.n, cols=knobs.get("cols", 8))
        return (x, torch.as_tensor(x, dtype=torch.float32, device=dev),
                spmm_oracle(A, x), {}, {})
    x = make_x(A.n)
    if strategy.endswith("-fp64"):
        return (x, torch.as_tensor(x, dtype=torch.float64, device=dev),
                spmv_oracle(A, x), {"rtol": FP64_RTOL, "abs_l2": 0.0},
                {"rel_tol": FP64_TWIN, "row_tol": FP64_TWIN})
    return (x, torch.as_tensor(x, dtype=torch.float32, device=dev),
            spmv_oracle(A, x), {}, {})


def median_ms(fn, *args):
    """Median device time of ``fn(*args)`` alone (no host time)."""
    return float(np.median(time_device(fn, *args, reps=20)))


def call_ms(fn, *args):
    """Median time of ``fn(*args)`` as its caller sees it (event pairs;
    the host's enqueue enters when it is the slower side). A plain
    version launches up to a thousand kernels a call, more than the
    device's launch queue holds, so it cannot be timed device-only."""
    return float(np.median(time_cuda(fn, *args, reps=20)))


def to_cpu(args):
    return [a.cpu() if isinstance(a, torch.Tensor) else
            tuple(t.cpu() for t in a) if isinstance(a, tuple) else a
            for a in args]


def written(name, args, out):
    """What a call's output holds: the slots of mid its table names for
    ``xpose_s1_slots`` (it leaves the others unwritten), else all of it."""
    if name != "xpose_s1_slots":
        return out
    return out.reshape(-1)[s1_slot_entries(args)[0].to(out.device)]


def fresh(name, args):
    """The arguments of one replay of a call: an in-place kernel's
    (``INPLACE``) first argument copied, so that each replay starts from
    the same y."""
    if name not in INPLACE:
        return args
    return (args[0].clone(), *args[1:])


def check_call(name, args, what):
    """Replay one kernel call of the path: the kernel against its plain
    version on the same inputs, where the kernel writes. Returns max
    |kernel - plain|."""
    out = written(name, args, KERNELS[name](*fresh(name, args)))
    plain = written(name, args, PLAIN[name](*fresh(name, args)))
    torch.cuda.synchronize()
    err = float((out - plain).abs().max()) if out.numel() else 0.0
    if name in ORDERED:
        exact = torch.equal(out.cpu(), PLAIN[name](*to_cpu(fresh(name,
                                                                args))))
        rel = float((out - plain).norm() / max(float(plain.norm()), 1e-30))
        ok = exact and rel <= (FP64_TWIN if out.dtype == torch.float64
                               else TWIN_REL_L2)
    elif name in EXACT_BOTH:
        cpu_args = to_cpu(fresh(name, args))
        ok = (torch.equal(out, plain) and torch.equal(
            out.cpu(), written(name, cpu_args, PLAIN[name](*cpu_args))))
    else:
        ok = torch.equal(out, plain)
    if not ok:
        raise AssertionError(f"{what}: {name} disagrees with its plain "
                             f"version (max |d| {err:.3e})")
    return err


def tensor_bytes(args) -> int:
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


def gather_flat(name, args):
    """(src, flat, ok) of one gather call: each output element's flat
    index into ``src`` and whether it reads the source at all (an index
    out of range gives 0.0)."""
    if name == "sorted_gather":
        base, src, p, l, P = args
        row = base.long().repeat_interleave(8)[:, None] * P + p.long()
    elif name == "ranked_gather":
        src, p, l = args
        P = src.shape[0]
        row = p.long()
    else:
        base8, src, p, l, P = args
        row = base8.long()[:, None] * 8 + p.long()
    ok = (p >= 0) & (p < P) & (l >= 0) & (l < BC) & (row < src.shape[0])
    return src, row * BC + l.long(), ok


def slot_cols(name, args):
    """Each slot's x column in a tile or fused kernel call (vals, idx,
    pan, x, ...), and whether it lies in x."""
    vals, idx, pan, x = args[:4]
    pw = args[6].panel_w if name.startswith("pell_fused") else args[5]
    rows = vals.shape[0]
    col = (pan[:rows // 8].long().repeat_interleave(8)[:, None] * (pw * BC)
           + (torch.arange(BC, device=vals.device) if idx is None
              else idx.long()))
    return col, (col >= 0) & (col < x.numel())


def segsum_rows(name, args):
    """(quantum-major 8-vectors, destination row block or -1) of a
    segment-sum call: the quanta that add nothing point at -1."""
    part, rbl, base, nw, h = args[:5]
    span, rps = (args[5], args[6]) if name == "span_segsum" else (1, args[5])
    nq = part.shape[1]
    g = rps // 8 * nq
    q = part.view(-1, 8, nq).transpose(1, 2).reshape(-1, 8)
    step_base = base.long().repeat_interleave(g) * h
    r = rbl.long()
    if name == "span_segsum":
        ok = (r >= step_base) & (r < step_base + span * h) & (r < nw * h)
        dest = r
    else:
        ok = (r >= 0) & (r < h)
        dest = step_base + r
    return q, torch.where(ok, dest, -1)


def core_cols(args):
    """Each slot's column in a ``lane_rows`` call (vals, idx, ctab, qptr,
    blk_lo, x), decoded from the compact index."""
    return lane_rows.decode_cols(args[1], args[2], args[0].numel())


def bound(name, args, out) -> tuple:
    """(bound_ms, bound_by) of one call: the bytes this call's data needs
    (inputs read once, the output written once) over the card's memory
    rate; operations over its f32 rate. A gather reads its index tables
    whole but only the distinct source elements its in-range indices
    name; a segment-sum reads rbl and its step table whole but only the
    partials of quanta that land in y; the tile and fused kernels read
    every slot (value and index), a panel id per tile, and only the
    distinct x elements their slots name (the fused one also its row
    blocks and step table)."""
    nbytes = tensor_bytes(args) + out.numel() * out.element_size()
    ops = 0
    ops_per_s = (F64_OPS_PER_S if out.dtype == torch.float64
                 else F32_OPS_PER_S)
    if name in ("pell_rows", "pell_rows_fp64", "lane_rows"):
        vals, x = args[0], args[-1]
        cols = core_cols(args) if name == "lane_rows" else args[1]
        ok = (cols >= 0) & (cols < x.numel())
        nbytes = (tensor_bytes(args[:-1])
                  + torch.unique(cols[ok]).numel() * x.element_size()
                  + out.numel() * out.element_size())
        ops = 2 * vals.numel()
    elif name in ("pell_tiles", "pell_fused", "pell_fused_fp64"):
        vals, idx, _, x = args[:4]
        col, ok = slot_cols(name, args)
        nbytes = (tensor_bytes((vals, idx)) + vals.shape[0] // 8 * 4
                  + torch.unique(col[ok]).numel() * x.element_size()
                  + out.numel() * out.element_size())
        if name != "pell_tiles":
            nbytes += tensor_bytes(args[4:6])
        ops = 2 * vals.numel()
    elif name == "lane_ell_fp64":
        ops = 2 * args[1].numel()
    elif name == "bcsr_spmm":
        vals, pan, rowptr, X = args[:4]
        T = vals.shape[0] // 8
        rows = (pan[:T].long()[:, None] * BC
                + torch.arange(BC, device=X.device))
        nbytes = (tensor_bytes((vals, pan[:T], rowptr))
                  + torch.unique(rows[rows < X.shape[0]]).numel()
                  * X.shape[1] * X.element_size()
                  + out.numel() * out.element_size())
        # the product needs the stored nonzeros' MACs, not the tiles' zeros
        ops = 2 * int((vals != 0).sum()) * X.shape[1]
    elif name in ("bcsr_bits", "bcsr_bits_spmm"):
        vals, x = args[1], args[5]
        width = x.shape[1] if x.dim() == 2 else 1
        _, col, _ = bits_entries(args)
        nbytes = (tensor_bytes(args[:5])
                  + torch.unique(col[col < x.shape[0]]).numel() * width
                  * x.element_size() + out.numel() * out.element_size())
        ops = 2 * vals.numel() * width
    elif name == "span_segsum":
        _, dest = segsum_rows(name, args)
        live = int((dest >= 0).sum())
        nbytes = (tensor_bytes(args[1:3]) + live * 8 * 4
                  + out.numel() * out.element_size())
        ops = live * 8
    elif name == "lane_ell_spmv":
        cfg = args[-1]
        ops = 2 * cfg.steps * cfg.QT * cfg.chunk * BC
    elif name == "lane_ell_sharded":
        ops = 2 * args[2].numel()
    elif name == "window_segsum":
        part, rbl, h = args[0], args[1], args[4]
        live = int(((rbl >= 0) & (rbl < h)).sum())
        ops = live * 8
        nbytes += live * 8 * part.element_size() - tensor_bytes((part,))
    elif name in ("stream_reduce", "stream_reduce_strided"):
        ops = args[0].numel()
    elif name in GATHERS:
        src, flat, ok = gather_flat(name, args)
        nbytes += (torch.unique(flat[ok]).numel() * src.element_size()
                   - tensor_bytes((src,)))
    elif name == "chips_products":
        cols, _, x = args
        reads = (cols >= 0) & (cols < x.numel())
        ops = int(reads.sum())
        nbytes += (torch.unique(cols[reads]).numel() * x.element_size()
                   - tensor_bytes((x,)))
    elif name == "heavy_land":
        # land read whole; per heavy row its sum, and its row of y read
        # and written
        land = args[2]
        ops = int((land >= 0).sum())
        nbytes = land.numel() * land.element_size() + ops * 12
    elif name == "xpose_mirror":
        x, flat = mirror_flat(args)
        rows = torch.unique(flat[flat < x.numel()] // BC)
        nbytes += (torch.clamp(x.numel() - rows * BC, max=BC).sum().item()
                   * 4 - tensor_bytes((x,)))
    elif name == "xpose_s1":
        _, col, _ = s1_slots(args)
        ops = col.numel()
        nbytes += (torch.unique(col).numel() * 4
                   - tensor_bytes(args[:2]))
    elif name == "xpose_s1_slots":
        pos, col, _, reads = s1_slot_entries(args)
        ops = int(reads.sum())
        nbytes = (tensor_bytes(args[1:4]) + pos.numel() * 4
                  + torch.unique(col[reads]).numel() * 4)
    elif name == "xpose_s3":
        src, _ = s3_slots(args)
        ops = args[1].shape[1] * BC
        nbytes += torch.unique(src).numel() * 4 - tensor_bytes(args[:1])
    elif name == "xpose_s3_rows":
        src, _ = s3_rows_slots(args)
        ops = src.numel()
        nbytes += torch.unique(src).numel() * 4 - tensor_bytes(args[:1])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits_entries(args):
    """(row, column, value) of every stored slot of a bitmap-tile call
    (bits, vals, vptr, pan, rowptr, x, m), in (tile, row, lane) order."""
    bits, vals, vptr, pan, rowptr = args[:5]
    mask, tiles = bcsr_bits.decode(bits, vals, vptr)
    t, r, lane = mask.nonzero(as_tuple=True)
    blk = torch.repeat_interleave(
        torch.arange(rowptr.numel() - 1, device=bits.device),
        (rowptr[1:] - rowptr[:-1]).long())
    return blk[t] * 8 + r, pan.long()[t] * BC + lane, tiles[t, r, lane]


def bits_library(args):
    """A cuSPARSE CSR product (SpMV, or SpMM for a 2-D X) of the matrix a
    bitmap-tile call holds: the function the kernel computes."""
    x, m = args[5], args[6]
    row, col, v = bits_entries(args)
    A = torch.sparse_coo_tensor(torch.stack([row, col]), v,
                                (m, x.shape[0])).coalesce().to_sparse_csr()
    x2 = x if x.dim() == 2 else x.view(-1, 1)
    return lambda: A.matmul(x2)


def free_bound_ms(args, out) -> float:
    """The format-free bound of a row-layout call: its entries (the slots
    with a nonzero value) at one value and one 4-byte column each, x and
    y, over the card's memory rate."""
    vals, x = args[0], args[-1]
    nnz = int((vals != 0).sum())
    nbytes = (nnz * (vals.element_size() + 4) + x.numel() * x.element_size()
              + out.numel() * out.element_size())
    return nbytes / HBM_BYTES_PER_S * 1e3


def gather_library(name, args):
    """One flat-index read for the same gather: ``src[flat]`` over the
    source with one 0.0 appended, out-of-range elements pointed at it."""
    src, flat, ok = gather_flat(name, args)
    flat = torch.where(ok, flat, src.numel())
    srcz = torch.cat([src.reshape(-1), src.new_zeros(1)])
    return lambda: srcz[flat]


def products_library(args):
    """One flat-index read of x for the slot products' columns:
    ``x_pad[cols]`` over x with one 0.0 appended, the columns that read
    nothing pointed at it (the gathers' yardstick; the multiply is not
    in it)."""
    cols, _, x = args
    flat = torch.where((cols >= 0) & (cols < x.numel()), cols.long(),
                       x.numel())
    xz = torch.cat([x, x.new_zeros(1)])
    return lambda: xz[flat]


def land_library(args):
    """``index_add_`` of the heavy rows' sums into a copy of y: the same
    sums into the same rows, as one PyTorch call (the copy is made
    once)."""
    y, ys, land = args
    sel = torch.nonzero(land >= 0).flatten()
    idx, vals = land[sel].long(), ys[sel]
    yc = y.clone().view(-1)
    return lambda: yc.index_add_(0, idx, vals).view_as(y)


def segsum_library(name, args):
    """``index_add_`` of the quantum-major partials into y, the quanta
    that add nothing pointed at one extra row."""
    q, dest = segsum_rows(name, args)
    q = q.contiguous()
    rows = args[3] * args[4]
    dest = torch.where(dest >= 0, dest, rows)
    return lambda: torch.zeros(rows + 1, 8, device=q.device) \
        .index_add_(0, dest, q)


def unpermute_library(args):
    """One flat-index read for the un-permute."""
    yp, bsrc = args
    b = torch.arange(yp.shape[0], device=yp.device)
    flat = ((b // pell.SORT_WIN * pell.SORT_WIN)[:, None] + bsrc.long()) \
        * 8 + torch.arange(8, device=yp.device)
    return lambda: yp.view(-1)[flat]


def fused_library(args):
    """A cuSPARSE CSR product of the matrix the fused kernel's tiles hold
    (in its row order: row block rbl, row r of the tile), in the kernel's
    dtype."""
    vals, idx, pan, x, rbl, base, cfg, _ = args
    col, _ = slot_cols("pell_fused", args)
    T = vals.shape[0] // 8
    row = (rbl.long().view(T, 1, cfg.nq, 1) * 8
           + torch.arange(8, device=vals.device).view(1, 8, 1, 1)) \
        .expand(T, 8, cfg.nq, cfg.quantum).reshape(-1, BC)
    nz = vals != 0
    A = torch.sparse_coo_tensor(
        torch.stack([row[nz], col[nz]]), vals[nz],
        (cfg.num_windows * cfg.h * 8, x.numel())).coalesce().to_sparse_csr()
    x2 = x.view(-1, 1)
    return lambda: A.matmul(x2)


def rows_library(args):
    """A cuSPARSE CSR product of the matrix a row-layout call holds (its
    slots with a nonzero value), in the kernel's dtype: for ``lane_rows``
    the core's own entries, the function the kernel computes."""
    vals, qptr, x = args[0], args[-3], args[-1]
    cols = core_cols(args) if len(args) == 6 else args[1]
    Q = vals.shape[1]
    m = qptr.numel() - 1
    row = torch.repeat_interleave(torch.arange(m, device=vals.device),
                                  (qptr[1:] - qptr[:-1]).long() * Q)
    nz = vals.reshape(-1) != 0
    A = torch.sparse_coo_tensor(
        torch.stack([row[nz], cols.reshape(-1)[nz].long()]),
        vals.reshape(-1)[nz], (m, x.numel())).coalesce().to_sparse_csr()
    x2 = x.view(-1, 1)
    return lambda: A.matmul(x2)


def tiles_library(args):
    """A cuSPARSE CSR product that forms the tile kernel's partials: one
    row per (tile row, quantum), ``(t*8 + r) * nq + j``, holding the
    slots of quantum j in row r of tile t (dense tiles: nq = 1)."""
    vals, _, _, x, quantum = args[:5]
    col, ok = slot_cols("pell_tiles", args)
    R, nq = vals.shape[0], BC // quantum
    row = torch.arange(R * nq, device=vals.device).view(R, nq, 1) \
        .expand(R, nq, quantum).reshape(R, BC)
    nz = (vals != 0) & ok
    A = torch.sparse_coo_tensor(
        torch.stack([row[nz], col[nz]]), vals[nz],
        (R * nq, x.numel())).coalesce().to_sparse_csr()
    x2 = x.view(-1, 1)
    return lambda: A.matmul(x2)


def mirror_flat(args):
    """(x, flat) of a mirror call: each output element's index into x, or
    x.numel() where it reads 0.0 (a source past x)."""
    x, msw, sel, sub = args
    v = torch.arange(sel.shape[0], device=x.device)[:, None]
    row = (msw.long()[v * 4 + sel.long().clamp(max=3)] * BC
           + sub.long())[:, :, None]
    flat = row * BC + torch.arange(BC, device=x.device)
    ok = ((sel < 4) & (sub < BC))[:, :, None] & (flat >= 0) \
        & (flat < x.numel())
    return x, torch.where(ok, flat, x.numel()).view(-1, BC)


def s1_slots(args):
    """The product slots of an S1 call that hold an entry: each slot's
    flat index into mid (B2, J1, 128), the flat index of the element of
    x_ext (x zero-padded to nw0 windows, then the mirror table) that it
    reads, and its value."""
    x, xm, win, gidx, asv, r2, r3, nw0, B2 = args
    J1, dev = win.numel(), x.device
    c1 = r3.long().view(J1, B2, BC)
    c1c = c1.clamp(max=BC - 1)
    r = r2.long().view(J1, B2, BC).gather(2, c1c)
    rc = r.clamp(max=BC - 1)
    step = torch.arange(J1, device=dev).view(J1, 1, 1)
    pos = (step * BC + rc) * BC + c1c
    g = gidx.view(-1).long()[pos]
    a = asv.view(-1)[pos]
    w = win.long().view(J1, 1, 1)
    ok = ((c1 < xpose_plan.CCAP) & (r < BC) & (g < BC) & (a != 0)
          & (w >= 0) & (w < nw0 + xm.shape[0] // BC))
    col = (w * BC + rc) * BC + g
    slot = ((torch.arange(B2, device=dev).view(1, B2, 1) * J1 + step) * BC
            + torch.arange(BC, device=dev))
    return slot[ok], col[ok], a[ok]


def s1_slot_entries(args):
    """(flat index into mid, x column, value, whether it reads x) of each
    slot an ``xpose_s1_slots`` call writes: padding and positions outside
    mid left out; a zero value or a column outside x writes 0.0 and reads
    no x."""
    x, head, code, val, B2, J1 = args
    pos, col, live = xpose.decode_slots(head, code, J1)
    keep = live & (pos >= 0) & (pos < B2 * J1 * BC)
    pos, col, v = pos[keep], col[keep], val[keep]
    return pos, col, v, (v != 0) & (col >= 0) & (col < x.numel())


def s1_slots_library(args):
    """A cuSPARSE CSR product that forms the slot table's products: one
    row per slot of mid, holding at most its one entry, over x itself."""
    x, B2, J1 = args[0], args[4], args[5]
    pos, col, v, reads = s1_slot_entries(args)
    A = torch.sparse_coo_tensor(
        torch.stack([pos[reads], col[reads]]), v[reads],
        (B2 * J1 * BC, x.numel())).coalesce().to_sparse_csr()
    x2 = x.view(-1, 1)
    return lambda: A.matmul(x2)


def s3_slots(args):
    """The occupied final slots of an S3 call: each slot's flat index into
    mid and the row of y_all whose sum it enters (the row whose end,
    named by the first extraction pass, is the first at or after it)."""
    mid, planes, m2 = args
    B2, J1 = mid.shape[:2]
    dev = mid.device
    P = planes.long().view(8, B2, BC, BC)
    sub, r3b, rpre1, ys1, r3y1 = P[:5]
    blk = torch.arange(B2, device=dev).view(B2, 1, 1)
    c = r3b.clamp(max=BC - 1)
    s = sub.gather(2, c)
    occ = (r3b < xpose_plan.CCAP) & (s < J1)
    src = ((blk * J1 + s) * BC + c)[occ]
    pos = ((blk * BC + torch.arange(BC, device=dev).view(1, BC, 1)) * BC
           + torch.arange(BC, device=dev))[occ]
    r = r3y1[:, :xpose.STAGE_ROWS]
    rc = r.clamp(max=BC - 1)
    fe = ys1[:, :xpose.STAGE_ROWS].gather(2, rc).clamp(max=BC - 1)
    end = (blk * BC + fe) * BC + rpre1.reshape(-1)[(blk * BC + fe) * BC + rc]
    row = blk + torch.arange(xpose.STAGE_ROWS * BC, device=dev).view(
        1, xpose.STAGE_ROWS, BC) * B2
    live = (r < BC) & (row < m2)
    end, order = end[live].sort()
    return src, row[live][order][torch.searchsorted(end, pos)]


def s3_rows_slots(args):
    """The product slots an ``xpose_s3_rows`` call adds: each one's flat
    index into mid and its row of y (pointers clamped as the kernel
    clamps them, positions outside mid left out: they read 0.0)."""
    mid, rowptr, pos = args
    S = pos.numel()
    lo = rowptr[:-1].long().clamp(0, S)
    hi = torch.maximum(rowptr[1:].long().clamp(0, S), lo)
    row = torch.repeat_interleave(torch.arange(lo.numel(), device=mid.device),
                                  hi - lo)
    k = torch.arange(row.numel(), device=mid.device) + torch.repeat_interleave(
        lo - torch.cumsum(hi - lo, 0) + (hi - lo), hi - lo)
    src = pos.long()[k]
    ok = (src >= 0) & (src < mid.numel())
    return src[ok], row[ok]


def s1_library(args):
    """A cuSPARSE CSR product that forms S1's product array: one row per
    product slot (k, s, c2), holding at most its one entry, over x_ext."""
    x, xm, nw0 = args[0], args[1], args[7]
    slot, col, a = s1_slots(args)
    xe = torch.zeros(nw0 * BC * BC + xm.numel(), device=x.device)
    xe[:x.numel()] = x
    xe[nw0 * BC * BC:] = xm.view(-1)
    J1, B2 = args[2].numel(), args[8]
    A = torch.sparse_coo_tensor(
        torch.stack([slot, col]), a,
        (B2 * J1 * BC, xe.numel())).coalesce().to_sparse_csr()
    x2 = xe.view(-1, 1)
    return lambda: A.matmul(x2)


def matrix_library(A, xd):
    """A cuSPARSE CSR product of the whole matrix with x (or with X, an
    SpMM), in the dtype of x."""
    dev = xd.device
    Acsr = torch.sparse_csr_tensor(
        torch.as_tensor(A.irp, dtype=torch.int64, device=dev),
        torch.as_tensor(A.ja, dtype=torch.int64, device=dev),
        torch.as_tensor(A.as_, dtype=xd.dtype, device=dev),
        size=(A.m, A.n))
    x2 = xd if xd.dim() == 2 else xd.view(-1, 1)
    return lambda: Acsr.matmul(x2)


def library(name, args, A, xd):
    """The PyTorch yardstick of one kernel call, or None."""
    if name in ("window_segsum", "span_segsum"):
        return segsum_library(name, args)
    if name in GATHERS:
        return gather_library(name, args)
    if name == "chips_products":
        return products_library(args)
    if name == "heavy_land":
        return land_library(args)
    if name == "unpermute":
        return unpermute_library(args)
    if name in ("pell_fused", "pell_fused_fp64"):
        return fused_library(args)
    if name in ("pell_rows", "pell_rows_fp64", "lane_rows"):
        return rows_library(args)
    if name == "pell_tiles":
        return tiles_library(args)
    if name in ("bcsr_bits", "bcsr_bits_spmm"):
        return bits_library(args)
    if name == "xpose_mirror":
        x, flat = mirror_flat(args)
        xz = torch.cat([x, x.new_zeros(1)])
        return lambda: xz[flat]
    if name == "xpose_s1":
        return s1_library(args)
    if name == "xpose_s1_slots":
        return s1_slots_library(args)
    if name == "xpose_s3":
        src, dest = s3_slots(args)
        midf, m2 = args[0].view(-1), args[2]
        return lambda: torch.zeros(m2, device=midf.device) \
            .index_add_(0, dest, midf[src])
    if name == "xpose_s3_rows":
        src, dest = s3_rows_slots(args)
        midf, m = args[0].view(-1), args[1].numel() - 1
        return lambda: torch.zeros(m, device=midf.device) \
            .index_add_(0, dest, midf[src])
    if name in ("lane_ell_spmv", "lane_ell_sharded", "lane_ell_fp64",
                "bcsr_spmm") and A is not None:
        return matrix_library(A, xd)
    return None          # the core without its whole matrix


def kernel_table(prep, xd, what, A=None):
    """Each kernel of one call, replayed alone at the call's shapes:
    per kernel name the summed ms, plain ms, library ms, bound ms and
    the largest |kernel - plain|. ``A``: the whole matrix, whose cuSPARSE
    product is the core's yardstick."""
    rows = {}
    for name, args in prep.kernel_calls(xd):
        err = check_call(name, args, what)
        fn = KERNELS[name]
        plainfn = PLAIN[name]
        out = fn(*fresh(name, args))
        b_ms, b_by = bound(name, args, out)
        lib = library(name, args, A, xd)
        r = rows.setdefault(name, {"calls": 0, "ms": 0.0, "plain_ms": 0.0,
                                   "library_ms": None, "bound_ms": 0.0,
                                   "bound_by": b_by, "max_abs_err": 0.0})
        r["calls"] += 1
        r["ms"] += median_ms(fn, *args)
        r["plain_ms"] += call_ms(plainfn, *args)
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + median_ms(lib)
        r["bound_ms"] += b_ms
        if name in ("pell_rows", "pell_rows_fp64", "lane_rows"):
            r["free_ms"] = r.get("free_ms", 0.0) + free_bound_ms(args, out)
        r["max_abs_err"] = max(r["max_abs_err"], err)
    return rows


def host_vs_device(fn, xd, calls=200):
    """Per-call host enqueue time and device time of ``calls`` calls
    back to back (the device clock spans the first enqueue to the last
    kernel's end)."""
    fn(xd)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(xd)
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    end.record()
    torch.cuda.synchronize()
    return host_ms, start.elapsed_time(end) / calls


def profile_window(fn, xd, calls):
    """One torch.profiler window of ``calls`` calls: (its key averages,
    the wall ms of the calls, the port's launches in it)."""
    from torch.profiler import ProfilerActivity, profile
    before = sum(counts().values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(xd)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof.key_averages(), wall_ms, sum(counts().values()) - before


def device_busy(fn, xd, calls=50, tries=3):
    """Device time per call by kernel (or copy) name, the device's busy
    time per call and its idle share, from a torch.profiler window of
    ``calls`` calls that saw every launch: the device events of the
    port's kernels (every name outside PyTorch's ``at::`` kernels and the
    copies) at least the launch counts over the same calls, and the
    device kernel events exactly the host's ``cudaLaunchKernel`` calls.
    A window that lost events (or took in events from outside it) is
    measured again, up to ``tries`` windows. Returns (by name, busy ms a
    call, idle share or None where no window saw every launch, the
    counts line). Only device-side events count: a CPU op's device time
    is its kernels', which are listed on their own."""
    from torch.autograd import DeviceType
    fn(xd)
    torch.cuda.synchronize()
    for k in range(1, tries + 1):
        events, wall_ms, launched = profile_window(fn, xd, calls)
        dev = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
        kernels = [ev for ev in dev if not ev.key.startswith(("Memcpy",
                                                              "Memset"))]
        ours = sum(ev.count for ev in kernels if "at::" not in ev.key)
        seen = sum(ev.count for ev in kernels)
        host = sum(ev.count for ev in events
                   if ev.key.startswith("cudaLaunchKernel"))
        whole = ours >= launched and seen == host
        if whole:
            break
    line = (f"window {k} of {tries}: kernel events {ours} of the port's for "
            f"{launched} launches, {seen} in all for {host} cudaLaunchKernel "
            "calls")
    by_name = {ev.key: ev.self_device_time_total / 1e3 / calls for ev in dev}
    busy = sum(by_name.values())
    idle = 1.0 - busy * calls / wall_ms if whole else None
    return by_name, busy, idle, line


def phase_line(rows):
    out = []
    for k, r in rows.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        free = (f", format-free bound {r['free_ms']:.4f}" if "free_ms" in r
                else "")
        out.append(f"{k} x{r['calls']} {r['ms']:.4f} ms (plain "
                   f"{r['plain_ms']:.4f}, library {lib}, bound "
                   f"{r['bound_ms']:.4f}{free}, max|d| "
                   f"{r['max_abs_err']:.1e})")
    return " | ".join(out)


def layout_meta(pm):
    """What a line says of a PELL plan's meta (either layout)."""
    if pm.get("layout") == "rows":
        return (f"PELL rows quantum {pm['quantum']} quanta {pm['quanta']} "
                f"blocks {pm['blocks']} fill {pm['fill']:.4f}")
    if pm.get("layout") == "bits":
        return (f"BCSR bits tiles {pm['num_blocks']} stored {pm['stored']} "
                f"block_rows {pm['block_rows']} fill {pm['fill']:.4f}")
    scheme = pm.get("scheme", "fused" if "quantum" in pm else "bcsr")
    cols = "".join(f" {k} {pm[k]}" for k in ("stripes", "hot_cols",
                                             "split_shift") if pm.get(k))
    return (f"PELL scheme {scheme} quantum "
            f"{pm.get('quantum', BC)} panel_w {pm.get('panel_w', 1)} "
            f"row_sort {pm.get('row_sort', False)} chunk {pm.get('chunk')} "
            f"window_h {pm.get('window_h')} tiles {pm.get('num_blocks')} "
            f"fill {pm.get('fill', 0.0):.4f}{cols}")


def pell_meta(prep):
    """What a PELL-family path's line says of its plan."""
    m = prep.meta
    tail = m.get("tail_meta") if isinstance(m.get("tail_meta"), dict) \
        else {}
    pm = tail if "scheme" in tail or "layout" in tail else m
    return (f"{prep.strategy} delegated {m.get('delegated')} d_cov "
            f"{m.get('d_cov')} | tail_nnz {m.get('tail_nnz')} tail_kind "
            f"{m.get('tail_kind')} | {layout_meta(pm)}")


def xpose_meta(m):
    """What a line says of an XPOSE plan's meta."""
    return (f"J1 {m['J1']} B2 {m['B2']} W1 {m['W1']} NWm {m['NWm']} fill "
            f"{m['fill']:.4f} x_bytes {m['x_bytes']} s3 {m['s3']}")


def full_path(name, A, strategy, knobs, dev, card, kernels, branch,
              branch_what, timing=True, describe=pell_meta, profile=False,
              prepare=None, forbid=()):
    """One full-size path: the launch counts set to 0, ``A`` prepared
    (packing timed), the call validated against the oracle and timed, the
    counts read; then the branch ``branch(meta)``, the ``kernels`` that
    must have launched and the ``forbid`` ones that must not are checked, the call held against its plain
    call and each kernel replayed alone. ``timing`` adds host enqueue
    against device time over 200 calls, ``profile`` a profiler window;
    ``describe(prep)`` says what the line prints of the plan. ``prepare``
    (a row-sharded prepare function, its mesh in ``knobs``) replaces the
    strategy's. Returns (the kernel table, the counts, the prepared call,
    its timed result). The input and tolerances follow the strategy
    (``path_input``)."""
    x, xd, gold, vkw, tkw = path_input(A, strategy, knobs, dev)
    reset_counts()
    t0 = time.perf_counter()
    if prepare is None:
        prep = get_strategy(strategy).prepare(A, device=dev, **knobs)
    else:
        prep = prepare(A, **knobs)
    pack_s = time.perf_counter() - t0
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what=f"{strategy} on {name}", **vkw)
    r = time_prepared(prep, x, dtype=xd.dtype)
    validate_result(gold, r.data, what=f"{strategy} timed run, {name}",
                    **vkw)
    launched = counts()
    if not branch(prep.meta):
        raise AssertionError(f"{name}: {prep.strategy} did not take "
                             f"{branch_what} (meta {prep.meta})")
    require(launched, kernels, name, forbid)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd), name,
                                    **tkw)
    table = kernel_table(prep, xd, name, A=A)
    print(f"[{name}] nnz {A.nnz} pack {pack_s:.2f} s | {describe(prep)} | "
          f"hbm_bytes {prep.hbm_bytes} | vs oracle rel {rel_o:.3e} | vs "
          f"plain rel-L2 {rel_l2:.3e} row {row_rel:.3e}", flush=True)
    report_times(name, prep, xd, r, launched, card, timing, profile)
    print(f"[{name}] kernels alone: {phase_line(table)}", flush=True)
    return table, launched, prep, r


def report_times(name, prep, xd, r, launched, card, timing, profile):
    """The call's time line: the timed median, optionally host enqueue
    against device time over 200 calls and a profiler window (device busy
    time, idle share, device ms by kernel)."""
    hd = ""
    if timing:
        host_ms, dev_ms = host_vs_device(prep.fn, xd)
        hd = (f" | 200 calls back to back: host enqueue {host_ms:.4f} "
              f"ms/call, device {dev_ms:.4f} ms/call")
    if profile:
        by_name, busy_ms, idle, seen = device_busy(prep.fn, xd)
        hd += (f" | profiler, 50 calls, {seen}; " + (
            f"device busy {busy_ms:.4f} ms/call, idle share {idle:.3f}"
            if idle is not None else
            "events lost in every window: no idle share, the window's "
            "device times are not the call's"))
    print(f"[{name}] call {r.duration_ms:.4f} ms = {r.gflops:.2f} GFLOP/s "
          f"(median of {r.reps}){hd} | launches {launched} | {card}",
          flush=True)
    if profile:
        lost = "" if idle is not None else " (a window that lost events)"
        print(f"[{name}] device ms/call by name{lost}: " + ", ".join(
            f"{k[:60]} {v:.4f}" for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:12]), flush=True)


def layout_ab(name, old, new, xd, card, old_kernels=("pell_fused",)):
    """The tile layout's fused kernel (``old``'s call; with
    ``old_kernels`` naming more, those of its calls too, launched back to
    back) against the row layout's (``new``'s) on one matrix, in turns
    (old, new, new, old) in this run, and the two whole calls the same
    way; beside them cuSPARSE's CSR product of the matrix the row layout
    holds, the two formats' bounds and bytes, and the format-free
    bound."""
    oc = [c for c in old.kernel_calls(xd) if c[0].startswith(old_kernels)]
    (kn, an), = [c for c in new.kernel_calls(xd)
                 if c[0].startswith("pell_rows")]
    kern = {"old": [], "new": []}
    call = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        kern[side].append(median_ms(run_calls(oc)) if side == "old"
                          else median_ms(KERNELS[kn], *an))
    for side in ("old", "new", "new", "old"):
        call[side].append(call_ms((old if side == "old" else new).fn, xd))
    out_n = KERNELS[kn](*an)
    nnz = int((an[0] != 0).sum())
    b_old = sum(bound(k, a, KERNELS[k](*a))[0] for k, a in oc)
    b_new = bound(kn, an, out_n)[0]
    ko = "+".join(k for k, _ in oc)
    rows_b = tensor_bytes(an[:4])
    # the tiles of every call of the first kernel (each stripe's)
    tiles_b = sum(tensor_bytes(a[:3]) for k, a in oc if k == oc[0][0])

    def ms(v):
        return ", ".join(f"{t:.4f}" for t in v)

    print(f"[{name}] A/B in turns (old, new, new, old): {ko} {ms(kern['old'])}"
          f" ms, {kn} {ms(kern['new'])} ms | whole call, tiles "
          f"{ms(call['old'])} ms, rows {ms(call['new'])} ms | cuSPARSE CSR "
          f"{median_ms(rows_library(an)):.4f} ms | bound: rows {b_new:.4f}, "
          f"tiles {b_old:.4f}, format-free {free_bound_ms(an, out_n):.4f} ms"
          f" | format bytes for {nnz} entries: rows {rows_b} "
          f"({rows_b / max(nnz, 1):.2f} B/nnz), tiles {tiles_b} "
          f"({tiles_b / max(nnz, 1):.2f} B/nnz) | {card}", flush=True)


def run_calls(calls):
    """A function that launches the kernel calls ``calls`` back to
    back."""
    def run():
        for k, a in calls:
            KERNELS[k](*a)
    return run


def bits_ab(name, old, new, xd, A, card):
    """The dense tiles (``old``: its kernel calls, summed) against the
    bitmap tiles (``new``: its one kernel) of one matrix, in turns (old,
    new, new, old) in this run, and the two whole calls the same way;
    beside them cuSPARSE's CSR product of A (SpMV, or SpMM for a 2-D X),
    the two layouts' bounds and their bytes per entry."""
    oc = old.kernel_calls(xd)
    (kn, an), = new.kernel_calls(xd)
    kern = {"old": [], "new": []}
    call = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        kern[side].append(sum(median_ms(KERNELS[k], *a) for k, a in oc)
                          if side == "old" else median_ms(KERNELS[kn], *an))
    for side in ("old", "new", "new", "old"):
        call[side].append(call_ms((old if side == "old" else new).fn, xd))
    b_old = sum(bound(k, a, KERNELS[k](*a))[0] for k, a in oc)
    b_new = bound(kn, an, KERNELS[kn](*an))[0]

    def ms(v):
        return ", ".join(f"{t:.4f}" for t in v)

    print(f"[{name}] A/B in turns (old, new, new, old): "
          f"{'+'.join(k for k, _ in oc)} {ms(kern['old'])} ms, {kn} "
          f"{ms(kern['new'])} ms | whole call, tiles {ms(call['old'])} ms, "
          f"bits {ms(call['new'])} ms | cuSPARSE CSR of A "
          f"{median_ms(matrix_library(A, xd)):.4f} ms | bound: bits "
          f"{b_new:.4f}, tiles {b_old:.4f} ms | format bytes for {A.nnz} "
          f"nnz: bits {new.hbm_bytes} ({new.hbm_bytes / max(A.nnz, 1):.2f} "
          f"B/nnz), tiles {old.hbm_bytes} "
          f"({old.hbm_bytes / max(A.nnz, 1):.2f} B/nnz) | {card}",
          flush=True)


def bcsr_paths(name, A, strategy, knobs, dev, card, kernel, old_kernels,
               describe, timing=True):
    """A BCSR main path on the bitmap tiles (the default), which must
    launch ``kernel`` and none of ``old_kernels``; then the same matrix on
    ``layout="tiles"`` as a path of its own (counts set to 0 just before
    it), which must launch ``old_kernels``; then the A/B of the two.
    Returns both runs' kernel tables and counts."""
    bt, bcnt, new, _ = full_path(
        name, A, strategy, knobs, dev, card, (kernel,),
        lambda m: m.get("layout") == "bits", "the bitmap tiles",
        timing=timing, describe=describe, forbid=old_kernels)
    tt, tcnt, old, _ = full_path(
        f"{name}-tiles", A, strategy, {**knobs, "layout": "tiles"}, dev,
        card, old_kernels, lambda m: "layout" not in m, "the dense tiles",
        timing=False, describe=describe, forbid=(kernel,))
    _, xd, *_ = path_input(A, strategy, knobs, dev)
    bits_ab(name, old, new, xd, A, card)
    return bt, bcnt, tt, tcnt


def core_call(prep, xd):
    """(name, args) of the core kernel's call in one hybrid call."""
    return [c for c in prep.kernel_calls(xd) if c[0] in CORE_KERNELS][0]


def core_ab(name, new, old, xd, A, card):
    """The lanes core (``old``'s call) against the rows core (``new``'s)
    of one pack, in turns (old, new, new, old) in this run: each core
    kernel alone, then the two whole calls the same way; beside them
    cuSPARSE's CSR product of the core's own entries and of the whole
    matrix, each layout's bound and bytes, the rows core's geometry and
    the format-free bound."""
    kn, an = core_call(new, xd)
    ko, ao = core_call(old, xd)
    kern = {"old": [], "new": []}
    call = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        k, a = (ko, ao) if side == "old" else (kn, an)
        kern[side].append(median_ms(KERNELS[k], *a))
    for side in ("old", "new", "new", "old"):
        call[side].append(call_ms((old if side == "old" else new).fn, xd))
    out_o, out_n = KERNELS[ko](*ao), KERNELS[kn](*an)
    b_old, b_new = bound(ko, ao, out_o)[0], bound(kn, an, out_n)[0]
    vals, _, ctab = an[:3]
    nnz = int((vals != 0).sum())
    rows_b = tensor_bytes(an[:5])
    lanes_b = tensor_bytes(ao[1:4] if ko == "lane_ell_spmv" else ao[2:5])

    def ms(v):
        return ", ".join(f"{t:.4f}" for t in v)

    print(f"[{name}] core A/B in turns (old, new, new, old): {ko} "
          f"{ms(kern['old'])} ms, {kn} {ms(kern['new'])} ms | whole call, "
          f"lanes {ms(call['old'])} ms, rows {ms(call['new'])} ms | "
          f"cuSPARSE CSR of the core's entries "
          f"{median_ms(rows_library(an)):.4f} ms, of the whole matrix "
          f"{median_ms(matrix_library(A, xd)):.4f} ms | bound: rows "
          f"{b_new:.4f}, lanes {b_old:.4f}, format-free "
          f"{free_bound_ms(an, out_n):.4f} ms | rows core: Q "
          f"{vals.shape[1]} blocks {ctab.shape[0]} (32-bit "
          f"{int((ctab[:, 0] < 0).sum())}) | bytes for {nnz} core "
          f"entries: rows {rows_b} ({rows_b / max(nnz, 1):.2f} B/entry), "
          f"lanes planes {lanes_b} ({lanes_b / max(nnz, 1):.2f} B/entry) "
          f"| {card}", flush=True)


def layouts_path(name, A, knobs, dev, card, kernels, lanes_kernels, branch,
                 branch_what, describe, profile=False, forbid=(),
                 chips=False, landing=False):
    """A main path on both core layouts from one pack (the row-sharded
    hybrid's when ``knobs`` name a mesh): the rows core, the default,
    through ``full_path`` (its packing time covers both layouts), which
    must launch ``kernels`` and none of ``forbid``; then the lanes core's
    own run, with the counts set to 0 just before it, which must launch
    ``lanes_kernels``; then the A/B of the two cores. With ``chips`` the
    same pack binds the rows core with the chips tail on
    ``chips_x="hot"`` too, and the chips A/B follows (``chips_ab``); with
    ``landing`` it binds the rows core on ``landing="merge"`` too, and the
    landing A/B follows (``landing_ab``). Returns (the rows run's kernel
    table and counts, the lanes run's, the rows Prepared, its timed
    result)."""
    held = {}
    dist = "mesh" in knobs
    hot = ("rows", "hot")
    merge = ("rows", "slots", "merge")
    designs = (lane_ell.CORE_LAYOUTS + ((hot,) if chips else ())
               + ((merge,) if landing else ()))

    def prepare(A, **kw):
        held.update(distributed.row_sharded_hybrid_layouts(A, designs, **kw)
                    if dist else lane_ell.prepare_hybrid_layouts(
                        A, designs, device=dev, **kw))
        return held["rows"]

    strategy = "row-sharded-hybrid" if dist else "cuda-hybrid"
    rt, rc, rows, r = full_path(name, A, strategy, knobs, dev, card, kernels,
                                branch, branch_what, describe=describe,
                                profile=profile, prepare=prepare,
                                forbid=forbid)
    lt, lc, lanes, _ = full_path(
        f"{name}-lanes", A, strategy, knobs, dev, card, lanes_kernels,
        branch, branch_what, describe=lambda p: "packed with the rows core",
        timing=False, prepare=lambda A, **kw: held["lanes"])
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=dev)
    core_ab(name, rows, lanes, xd, A, card)
    if chips:
        chips_ab(name, held[hot], rows, xd, card)
    if landing:
        landing_ab(name, held[merge], rows, xd, card)
    return rt, rc, lt, lc, rows, r


def x_side_calls(hot, slots, xd):
    """The chips tails' gather calls in one call of ``hot`` (a chips tail
    on ``chips_x="hot"``): its gather calls whose index tables no gather
    call of ``slots`` (the same pack on the slot products) holds. The
    landing's panel merge and the ext route gather in both."""
    def tables(k, a):
        return a[1:3] if k == "ranked_gather" else a[2:4]

    theirs = [tables(k, a) for k, a in slots.kernel_calls(xd) if k in GATHERS]

    def shared(p, lane):
        return any(p.shape == q.shape and torch.equal(p, q)
                   and torch.equal(lane, r) for q, r in theirs)

    return [(k, a) for k, a in hot.kernel_calls(xd)
            if k in GATHERS and not shared(*tables(k, a))]


def chips_ab(name, old, new, xd, card):
    """The chips tail's x side on the two gather stages (``old``, the
    rows core with ``chips_x="hot"``: its stage-1 and stage-2 gather
    calls back to back) against the slot products (``new``, the default:
    its ``chips_products`` calls) of one pack, in turns (old, new, new,
    old), then the two whole calls the same way, whose y must be equal,
    and host enqueue against device time over 200 calls back to back,
    in turns; beside them the yardstick ``x_pad[cols]``, both bounds and
    each call's launches of the port's kernels."""
    y_old, y_new = old.fn(xd), new.fn(xd)
    if not torch.equal(y_old, y_new):
        raise AssertionError(f"{name}: y on the slot products differs from "
                             "y on the two gather stages")
    oc = x_side_calls(old, new, xd)
    nc = [c for c in new.kernel_calls(xd) if c[0] == "chips_products"]
    kern = {"old": [], "new": []}
    call = {"old": [], "new": []}
    hd = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        kern[side].append(median_ms(run_calls(oc if side == "old" else nc)))
    for side in ("old", "new", "new", "old"):
        call[side].append(call_ms((old if side == "old" else new).fn, xd))
    for side in ("old", "new", "new", "old"):
        hd[side].append(host_vs_device((old if side == "old" else new).fn,
                                       xd))
    b_old = sum(bound(k, a, KERNELS[k](*a))[0] for k, a in oc)
    b_new = sum(bound(k, a, KERNELS[k](*a))[0] for k, a in nc)
    lib = sum(median_ms(products_library(a)) for _, a in nc)
    names = "+".join(dict.fromkeys(k for k, _ in oc))

    print(f"[{name}] chips A/B in turns (old, new, new, old): {names} x"
          f"{len(oc)} {_ms(kern['old'])} ms, chips_products x{len(nc)} "
          f"{_ms(kern['new'])} ms | whole call, hot {_ms(call['old'])} ms, "
          f"slots {_ms(call['new'])} ms, y equal | host/device ms a call "
          f"over 200: hot {_hd(hd['old'])}, slots {_hd(hd['new'])} | "
          f"x_pad[cols] {lib:.4f} ms | bound: slots {b_new:.4f}, hot "
          f"{b_old:.4f} ms | kernel calls a call: hot "
          f"{len(old.kernel_calls(xd))}, slots {len(new.kernel_calls(xd))}"
          f" | {card}", flush=True)


def _hd(v):
    """Host enqueue / device ms pairs, as a line prints them."""
    return ", ".join(f"{h:.4f}/{d:.4f}" for h, d in v)


# the kernels of the landing on each design: the merge's segment-sums
# (one per stream and shard) and panel-merge gathers, and the direct
# design's one segment-sum and scatter
MERGE_LANDING = ("window_segsum", "ranked_gather", "window_gather")
DIRECT_LANDING = ("window_segsum", "heavy_land")


def landing_ab(name, old, new, xd, card):
    """The heavy-row landing on the reference's design (``old``, the rows
    core on ``landing="merge"``: each stream's and shard's segment-sum,
    then the panel merge's gathers and the torch ops around them) against
    the direct one (``new``, the default: one segment-sum for every
    stream and shard, one ``heavy_land``) of one pack, in turns (old,
    new, new, old): those kernel calls alone back to back, then the two
    whole calls, then host enqueue against device time over 200 calls
    back to back; beside them each design's port kernel calls a call,
    ``heavy_land`` alone, the merge's gathers alone, the ``index_add_``
    yardstick of the same sums into the same rows, and both bounds. The
    two y agree within rel-L2 1e-6 (a split plan's one segment-sum adds
    a heavy row's streams in another order)."""
    y_old, y_new = old.fn(xd), new.fn(xd)
    rel = float((y_old - y_new).norm() / max(float(y_old.norm()), 1e-30))
    if rel > TWIN_REL_L2:
        raise AssertionError(f"{name}: y on the direct landing is {rel:.3e}"
                             " from y on the merge")
    oc = [c for c in old.kernel_calls(xd) if c[0] in MERGE_LANDING]
    nc = [c for c in new.kernel_calls(xd) if c[0] in DIRECT_LANDING]
    (_, la), = [c for c in nc if c[0] == "heavy_land"]
    gathers = [c for c in oc if c[0] in GATHERS]
    kern = {"old": [], "new": []}
    call = {"old": [], "new": []}
    hd = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        kern[side].append(median_ms(run_calls(oc if side == "old" else nc)))
    for side in ("old", "new", "new", "old"):
        call[side].append(call_ms((old if side == "old" else new).fn, xd))
    for side in ("old", "new", "new", "old"):
        hd[side].append(host_vs_device((old if side == "old" else new).fn,
                                       xd))
    b_old = sum(bound(k, a, KERNELS[k](*fresh(k, a)))[0] for k, a in oc)
    b_new = sum(bound(k, a, KERNELS[k](*fresh(k, a)))[0] for k, a in nc)
    b_land = bound("heavy_land", la, KERNELS["heavy_land"](*fresh(
        "heavy_land", la)))[0]
    heavy = int((la[2] >= 0).sum())
    merged = (f"the merge's gathers x{len(gathers)} "
              f"{median_ms(run_calls(gathers)):.4f} ms" if gathers else
              "the merge past its budget: index_add_, no gather")
    print(f"[{name}] landing A/B in turns (old, new, new, old): merge "
          f"{'+'.join(dict.fromkeys(k for k, _ in oc))} x{len(oc)} "
          f"{_ms(kern['old'])} ms, direct "
          f"{'+'.join(k for k, _ in nc)} x{len(nc)} {_ms(kern['new'])} ms |"
          f" whole call, merge {_ms(call['old'])} ms, direct "
          f"{_ms(call['new'])} ms, y rel-L2 {rel:.2e} | host/device ms a "
          f"call over 200: merge {_hd(hd['old'])}, direct {_hd(hd['new'])}"
          f" | port kernel calls a call: merge {len(old.kernel_calls(xd))},"
          f" direct {len(new.kernel_calls(xd))} | {heavy} heavy rows: "
          f"heavy_land alone {median_ms(KERNELS['heavy_land'], *la):.4f} ms"
          f" (bound {b_land:.4f}), {merged}, index_add_ "
          f"{median_ms(land_library(la)):.4f} ms | bound: direct "
          f"{b_new:.4f}, merge {b_old:.4f} ms | {card}", flush=True)


def auto_xpose_path(name, A, dev, card, profile):
    """A main path of the scattered regime: ``pick_auto`` must choose
    ``cuda-xpose``, whose plan must accept the matrix (a refusal fails
    here, printing the planner's reason, rather than let ``spmv`` fall
    back to the hybrid). With the launch counts set to 0, ``spmv(A, x)``
    runs the auto route and must launch the two XPOSE kernels of the
    default design (S1 over the slot table, S3 as row sums) and no
    other; the prepared call is then validated and timed, the counts
    read, the call held against its plain call and ``spmv``'s y, and each
    kernel replayed alone. Then the same plan on ``s1="slab"``
    (``[name-slab]``) and on ``s3="prefix"`` (``[name-prefix]``), each a
    path of its own (counts set to 0 just before it), and the A/B of
    each against the default. Returns the kernel table and the counts of
    the default, the slab and the prefix runs."""
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    picked = pick_auto(A)
    if picked != "cuda-xpose":
        raise AssertionError(f"{name}: pick_auto chose {picked}, not "
                             "cuda-xpose")
    t0 = time.perf_counter()
    try:
        preps = xpose.prepare_xpose_designs(A, DESIGNS, device=dev)
    except ValueError as err:
        print(f"[{name}] the XPOSE planner refuses {A.nnz} nnz: "
              f"{xpose_plan.REJECT_REASON}", flush=True)
        raise AssertionError(f"{name}: {err}") from err
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = xpose_plan.plan_xpose(A)
    plan_s = time.perf_counter() - t0
    s3_pos = xpose.s3_rows_table(plan)[1]
    s3_s = time.perf_counter() - t0 - plan_s
    xpose.s1_slots_table(plan, s3_pos)
    s1_s = time.perf_counter() - t0 - plan_s - s3_s
    prep = preps["rows"]
    reset_counts()
    t0 = time.perf_counter()
    y_auto = spmv(A, x)
    auto_s = time.perf_counter() - t0
    auto_counts = counts()
    others = {k: v for k, v in auto_counts.items()
              if v and k not in XPOSE_KERNELS}
    require(auto_counts, XPOSE_KERNELS, f"{name} through spmv's auto route")
    if others:
        raise AssertionError(f"{name}: the auto route launched {others}")
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what=f"cuda-xpose on {name}")
    validate_result(gold, y_auto, what=f"spmv auto on {name}")
    r = time_prepared(prep, x)
    validate_result(gold, r.data, what=f"cuda-xpose timed run, {name}")
    launched = counts()
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd), name)
    auto_l2, _, _ = twin_check(A, x, torch.as_tensor(y_auto), prep.fn(xd),
                               f"{name}: spmv's y against the prepared call")
    table = kernel_table(prep, xd, name, A=A)
    m = prep.meta
    print(f"[{name}] nnz {A.nnz} ({A.nnz / A.m:.2f} per row) pick_auto "
          f"{picked} | pack {pack_s:.2f} s (the three designs; alone: plan "
          f"{plan_s:.2f} s, S3 row table {s3_s:.2f} s, S1 slot table "
          f"{s1_s:.2f} s), spmv auto "
          f"(pack + call) {auto_s:.2f} s | {xpose_meta(m)} virtual rows "
          f"{m['virtual_rows']} | hbm_bytes {prep.hbm_bytes} "
          f"({prep.hbm_bytes / A.nnz:.1f} B/nnz) | vs oracle rel "
          f"{rel_o:.3e} | vs plain rel-L2 {rel_l2:.3e} row {row_rel:.3e} | "
          f"spmv vs prepared rel-L2 {auto_l2:.3e}", flush=True)
    report_times(name, prep, xd, r, launched, card, True, profile)
    print(f"[{name}] kernels alone: {phase_line(table)}", flush=True)
    print(f"[{name}] cuSPARSE CSR of the whole matrix: "
          f"{median_ms(matrix_library(A, xd)):.4f} ms", flush=True)
    slab, slab_counts = design_path(f"{name}-slab", A, preps[DESIGNS[1]],
                                    dev, card, SLAB_KERNELS)
    s1_ab(name, preps[DESIGNS[1]], prep, xd, card)
    old, old_counts = design_path(f"{name}-prefix", A, preps["prefix"], dev,
                                  card, PREFIX_KERNELS)
    s3_ab(name, preps["prefix"], prep, xd, card)
    return table, launched, slab, slab_counts, old, old_counts


def design_path(name, A, prep, dev, card, kernels):
    """An XPOSE path on another design than the default: counts set to 0,
    the call validated and timed, the counts read (``kernels`` must
    launch, the default's kernels of the stage it replaces must not), the
    call held against its plain call and each kernel replayed alone.
    Returns (the kernel table, the counts)."""
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    reset_counts()
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what=f"{prep.strategy} on {name}")
    r = time_prepared(prep, x)
    validate_result(gold, r.data, what=f"{prep.strategy} timed run, {name}")
    launched = counts()
    require(launched, kernels, name, [k for k in XPOSE_KERNELS
                                      if k not in kernels])
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd), name)
    table = kernel_table(prep, xd, name, A=A)
    print(f"[{name}] hbm_bytes {prep.hbm_bytes} | vs oracle rel {rel_o:.3e}"
          f" | vs plain rel-L2 {rel_l2:.3e} row {row_rel:.3e}", flush=True)
    report_times(name, prep, xd, r, launched, card, False, False)
    print(f"[{name}] kernels alone: {phase_line(table)}", flush=True)
    return table, launched


def _ms(v):
    return ", ".join(f"{t:.4f}" for t in v)


def s1_ab(name, old, new, xd, card):
    """The slab S1 (``old``'s mirror and ``xpose_s1`` calls, launched back
    to back) against the slot table (``new``'s ``xpose_s1_slots``) of one
    plan, in turns (old, new, new, old), and the two whole calls the same
    way, whose y must be equal; beside them the slot kernel's yardstick,
    the two bounds and S1's input bytes."""
    pair = [c for c in old.kernel_calls(xd)
            if c[0] in ("xpose_mirror", "xpose_s1")]
    (kn, an), = [c for c in new.kernel_calls(xd) if c[0] == "xpose_s1_slots"]
    y_old, y_new = old.fn(xd), new.fn(xd)
    if not torch.equal(y_old, y_new):
        raise AssertionError(f"{name}: y on the slot table differs from y "
                             "on the slab")

    def run_pair():
        for k, a in pair:
            KERNELS[k](*a)

    kern = {"old": [], "new": []}
    call = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        kern[side].append(median_ms(run_pair) if side == "old"
                          else median_ms(KERNELS[kn], *an))
    for side in ("old", "new", "new", "old"):
        call[side].append(call_ms((old if side == "old" else new).fn, xd))
    b_old = sum(bound(k, a, KERNELS[k](*a))[0] for k, a in pair)
    b_new = bound(kn, an, KERNELS[kn](*an))[0]
    planes = sum(tensor_bytes(a[1:] if k == "xpose_mirror" else a[2:7])
                 for k, a in pair)
    print(f"[{name}] S1 A/B in turns (old, new, new, old): xpose_mirror + "
          f"xpose_s1 {_ms(kern['old'])} ms, {kn} {_ms(kern['new'])} ms | "
          f"whole call, slab {_ms(call['old'])} ms, slots "
          f"{_ms(call['new'])} ms, y equal | cuSPARSE "
          f"{median_ms(library(kn, an, None, xd)):.4f} ms | bound: slots "
          f"{b_new:.4f}, slab {b_old:.4f} ms | S1 input for "
          f"{s1_slot_entries(an)[0].numel()} slots: planes {planes} B, "
          f"table {tensor_bytes(an[1:4])} B | {card}", flush=True)


def s3_ab(name, old, new, xd, card):
    """The prefix S3 (``old``'s call; then its virtual rows'
    ``index_add_``, outside the kernel) against the row sums (``new``'s)
    of one plan, in turns (old, new, new, old), and the two whole calls
    the same way; beside them the row sums' yardstick (gather +
    ``index_add_``), the two bounds and S3's bytes."""
    (ko, ao), = [c for c in old.kernel_calls(xd) if c[0] == "xpose_s3"]
    (kn, an), = [c for c in new.kernel_calls(xd) if c[0] == "xpose_s3_rows"]
    kern = {"old": [], "new": []}
    call = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        k, a = (ko, ao) if side == "old" else (kn, an)
        kern[side].append(median_ms(KERNELS[k], *a))
    for side in ("old", "new", "new", "old"):
        call[side].append(call_ms((old if side == "old" else new).fn, xd))
    b_old = bound(ko, ao, KERNELS[ko](*ao))[0]
    b_new = bound(kn, an, KERNELS[kn](*an))[0]
    slots = an[2].numel()
    print(f"[{name}] S3 A/B in turns (old, new, new, old): {ko} "
          f"{_ms(kern['old'])} ms, {kn} {_ms(kern['new'])} ms | whole call,"
          f" prefix {_ms(call['old'])} ms, rows {_ms(call['new'])} ms | "
          f"gather + index_add_ {median_ms(library(kn, an, None, xd)):.4f} "
          f"ms | bound: rows {b_new:.4f}, prefix {b_old:.4f} ms | S3 input "
          f"for {slots} products: planes {tensor_bytes(ao[1:2])} B, table "
          f"{tensor_bytes(an[1:])} B | {card}", flush=True)


def small_phase(tag, items, kernels, describe, dev, what):
    """Small cases ``(name, A, strategy, knobs)``: each call against its
    plain call and the oracle, each kernel call replayed against its plain
    version; the ``kernels`` must launch across the cases.
    ``describe(prep, A)`` says what a case's line prints of its plan."""
    launches = dict.fromkeys(kernels, 0)
    for name, A, strategy, kw in items:
        prep = get_strategy(strategy).prepare(A, device=dev, **kw)
        x, xd, gold, vkw, tkw = path_input(A, strategy, kw, dev)
        before = counts()
        yk = prep.fn(xd)
        torch.cuda.synchronize()
        after = counts()
        for k in kernels:
            launches[k] += after[k] - before[k]
        rel_l2, row_rel, dmax = twin_check(A, x, yk, prep.plain(xd), name,
                                           **tkw)
        rel_o = validate_result(gold, to_numpy(yk),
                                what=f"{strategy} on {name}", **vkw)
        calls = prep.kernel_calls(xd)
        errs = [check_call(k, a, name) for k, a in calls]
        print(f"[{tag}] {name}: {describe(prep, A)} | vs plain rel-L2 "
              f"{rel_l2:.3e} row {row_rel:.3e} max|d| {dmax:.3e} | vs oracle "
              f"rel {rel_o:.3e} | kernels {[k for k, _ in calls]} each vs "
              f"plain max|d| {max(errs):.1e}", flush=True)
    require(launches, kernels, what)
    print(f"[{tag}] launches across the cases: {launches}", flush=True)


def hybrid_small_meta(prep, A):
    m = prep.meta
    return (f"nnz {A.nnz} QT {m['slots'] + m['ov_slots']} idx8 "
            f"{m['idx8_planes']} hot {m['hot_strips']} dyn {m['dyn_planes']} "
            f"ext {m['ext']} (windowed {m['ext_windowed']}) tail "
            f"{m['tail_nnz']} {m['tail_kind']}")


def pell_small_meta(prep, A):
    return f"{prep.strategy} nnz {A.nnz} {layout_meta(prep.meta)}"


def column_small_meta(prep, A):
    m = prep.meta
    if "tail_kind" in m:
        return (f"{prep.strategy} nnz {A.nnz} tail_nnz {m['tail_nnz']} "
                f"tail {m['tail_kind']}")
    return f"{prep.strategy} nnz {A.nnz} {layout_meta(m)}"


def xpose_small_meta(prep, A):
    m = prep.meta
    if "tail_kind" in m:
        return (f"{prep.strategy} nnz {A.nnz} tail {m['tail_kind']} "
                f"{xpose_meta(m['tail_meta'])}")
    return f"{prep.strategy} nnz {A.nnz} {xpose_meta(m)}"


def xpose_phases(dev, card):
    """Phases 13-16: the small XPOSE cases and the hybrid with an XPOSE
    big tail, the scattered regime's two main paths through the auto
    route, and near/far on amazon262k. Returns webbase1m's kernel tables
    and counts on the default, slab and prefix designs, which the
    kernels line reports."""
    # 13. the small XPOSE cases, and the hybrid with an XPOSE big tail,
    # each on the three designs
    spec, tail_kw = cases.XPOSE_TAIL
    variants = (("", {}), ("-slab", {"s1": "slab"}),
                ("-prefix", {"s3": "prefix"}))
    small = [(f"{name}{sfx}", cases.make(sp), "cuda-xpose", kw)
             for name, sp in cases.XPOSE_CASES.items()
             for sfx, kw in variants]
    small += [(f"amazon20k-xpose-tail{sfx}", cases.make(spec), "cuda-hybrid",
               {**tail_kw, **{f"xpose_{k}": v for k, v in kw.items()}})
              for sfx, kw in variants]
    small_phase("small-xpose", small, XPOSE_KERNELS + PREFIX_KERNELS,
                xpose_small_meta, dev, "small XPOSE cases")

    # 14-15. main paths 6 and 7: the scattered regime through spmv's auto
    # route, which must pick cuda-xpose, each then on s1="slab" and on
    # s3="prefix"
    wx = auto_xpose_path("webbase1m-xpose", cases.webbase1m(), dev, card,
                         profile=True)
    auto_xpose_path("random30k", cases.random30k(), dev, card,
                    profile=False)

    # 16. main path 8: amazon262k through cuda-nearfar, the band on the
    # hybrid and the scattered rest on XPOSE, then on s1="slab" and on
    # s3="prefix"
    A = cases.amazon262k()
    _, _, new, _ = full_path(
        "amazon262k-nearfar", A, "cuda-nearfar", {}, dev,
        card, ("lane_rows",) + XPOSE_KERNELS, lambda m: "W" in m,
        "the split into band and scattered rest",
        describe=lambda p: (
            f"W {p.meta['W']} near_frac {p.meta['near_frac']} near_nnz "
            f"{p.meta['near_nnz']} far_nnz {p.meta['far_nnz']} | near: "
            f"tail {p.meta['near']['tail_kind']} ext {p.meta['near']['ext']}"
            f" | far: {xpose_meta(p.meta['far'])}"), profile=True,
        forbid=("xpose_mirror", "xpose_s1", "xpose_s3"))
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=dev)
    nearfar = get_strategy("cuda-nearfar")
    slab = nearfar.prepare(A, device=dev, s1="slab")
    design_path("amazon262k-nearfar-slab", A, slab, dev, card,
                ("lane_rows",) + SLAB_KERNELS)
    s1_ab("amazon262k-nearfar", slab, new, xd, card)
    old = nearfar.prepare(A, device=dev, s3="prefix")
    design_path("amazon262k-nearfar-prefix", A, old, dev, card,
                ("lane_rows",) + PREFIX_KERNELS)
    s3_ab("amazon262k-nearfar", old, new, xd, card)
    return wx


def fp64_spmm_meta(prep):
    """What a line says of an fp64 or SpMM plan."""
    m = prep.meta
    if prep.strategy == "cuda-bcsr-spmm":
        return (f"{prep.strategy} nnz {prep.nnz} cols {m['cols']} layout "
                f"{m.get('layout', 'tiles')} tiles {m['num_blocks']} fill "
                f"{m['fill']:.4f}")
    if prep.strategy == "cuda-hybrid-fp64":
        return (f"{prep.strategy} nnz {prep.nnz} loc_w {m['loc_w']} Q "
                f"{m['slots']} chunk {m['chunk']} steps {m['steps']} fill "
                f"{m['fill']:.4f}")
    return f"{prep.strategy} nnz {prep.nnz} {layout_meta(m)}"


def fp64_spmm_phases(dev, card, flagship_A, PL):
    """Phases 17-21: the small fp64 and SpMM cases, then the fp64 grade
    on the flagship (lane-ELL) and on powerlaw100k (``PL``: PELL on the
    row layout, then on the tile layout, then the two kernels in turns),
    and the SpMM at 8 columns on the flagship and 64 on stencil48k.
    Returns the kernel tables and counts of the flagship-fp64, both
    powerlaw100k-fp64 and flagship-spmm8 paths, which the kernels line
    reports."""
    # 17. the small cases, the fp64 PELL ones on both layouts
    small = [(name, make(), strategy, kw) for name, (make, strategy, kw)
             in cases.FP64_CASES.items()]
    small += [(f"{name}-tiles", A, strategy, {**kw, "layout": "tiles"})
              for name, A, strategy, kw in small
              if strategy == "cuda-pell-fp64"]
    small += [(name, make(), "cuda-bcsr-spmm", kw)
              for name, (make, kw) in cases.SPMM_CASES.items()]
    small += [(f"{name}-tiles", A, strategy, {**kw, "layout": "tiles"})
              for name, A, strategy, kw in small
              if strategy == "cuda-bcsr-spmm"]
    small_phase("small-fp64-spmm", small, FP64_SPMM_KERNELS,
                lambda p, _: fp64_spmm_meta(p), dev,
                "small fp64 and SpMM cases")

    # 18. main path 9: the flagship at fp64 grade through the lane-ELL
    # kernel, beside the torch-ell-fp64 baseline
    A = flagship_A
    fl, fl_counts, *_ = full_path(
        "flagship-fp64", A, "cuda-hybrid-fp64", {}, dev, card,
        ("lane_ell_fp64",), lambda m: m["rtol"] == FP64_RTOL,
        "the fp64 grade", describe=fp64_spmm_meta)
    x, xd, gold, vkw, _ = path_input(A, "torch-ell-fp64", {}, dev)
    t0 = time.perf_counter()
    base = get_strategy("torch-ell-fp64").prepare(A, device=dev)
    pack_s = time.perf_counter() - t0
    rel_b = validate_result(gold, to_numpy(base.fn(xd)),
                            what="torch-ell-fp64 on the flagship", **vkw)
    print(f"[flagship-fp64] baselines: torch-ell-fp64 call "
          f"{call_ms(base.fn, xd):.4f} ms (pack {pack_s:.2f} s, vs oracle "
          f"rel {rel_b:.3e}) | cuSPARSE fp64 CSR "
          f"{median_ms(matrix_library(A, xd)):.4f} ms | {card}", flush=True)
    del base

    # 19. main path 10: powerlaw100k at fp64 grade through PELL on the row
    # layout, then on the tile layout, then the two kernels in turns
    pw, pw_counts, pw_prep, _ = full_path(
        "powerlaw100k-fp64", PL, "cuda-pell-fp64", {}, dev, card,
        ("pell_rows_fp64",),
        lambda m: m["rtol"] == FP64_RTOL and m["layout"] == "rows",
        "the fp64 grade on the row layout", describe=fp64_spmm_meta)
    pt, pt_counts, pt_prep, _ = full_path(
        "powerlaw100k-fp64-tiles", PL, "cuda-pell-fp64", {"layout": "tiles"},
        dev, card, ("pell_fused_fp64",),
        lambda m: m["rtol"] == FP64_RTOL and "layout" not in m,
        "the fp64 grade on the tile layout", describe=fp64_spmm_meta,
        timing=False)
    layout_ab("powerlaw100k-fp64", pt_prep, pw_prep,
              torch.as_tensor(make_x(PL.n), dtype=torch.float64, device=dev),
              card)
    del pw_prep, pt_prep

    # 20-21. main paths 11 and 12: the SpMM at 8 and 64 columns, each on
    # the bitmap tiles, then on the dense tiles, then the two in turns
    sp, sp_counts, st, st_counts = bcsr_paths(
        "flagship-spmm8", A, "cuda-bcsr-spmm", {"cols": 8}, dev, card,
        "bcsr_bits_spmm", ("bcsr_spmm",), fp64_spmm_meta)
    bcsr_paths("stencil48k-spmm64", cases.stencil48k(), "cuda-bcsr-spmm",
               {"cols": 64}, dev, card, "bcsr_bits_spmm", ("bcsr_spmm",),
               fp64_spmm_meta)
    return (fl, fl_counts, pw, pw_counts, pt, pt_counts, sp, sp_counts, st,
            st_counts)


def dist_meta(prep):
    """What a row-sharded path's line says of its plan."""
    m = prep.meta
    if prep.strategy == "row-sharded-pell" and m.get("layout") == "rows":
        return (f"{prep.strategy} shards {len(prep.mesh)} h_rows "
                f"{m['h_rows']} | PELL rows quantum {m['quantum']} quanta "
                f"{m['quanta']} blocks {m['blocks']} fill {m['fill']:.4f}")
    if prep.strategy == "row-sharded-pell":
        return (f"{prep.strategy} shards {len(prep.mesh)} tiles: quantum "
                f"{m['quantum']} panel_w {m['panel_w']} row_sort "
                f"{m['row_sort']} chunk {m['chunk']} window_h {m['window_h']}"
                f" span {m['span']} tiles {m['tiles']}")
    if prep.strategy != "row-sharded-hybrid":
        return f"{prep.strategy} shards {len(prep.mesh)}"
    streams = ""
    tail = m.get("tail_meta") or []
    if tail and tail[0]["split"]:
        streams = " | streams per shard (loc/far/cold entries, H_pad): " + \
            ", ".join(f"{t['loc_entries']}/{t['far_entries']}/"
                      f"{t['cold_entries']} {t['hot_h']}" for t in tail)
    return (f"{prep.strategy} shards {len(prep.mesh)} bounds "
            f"{prep.bounds.tolist()} loc_w {m['loc_w']} QT {m['slots']} "
            f"strips {m['strips']} idx8 {m['idx8_planes']} chunk "
            f"{m['chunk']} | ext {m['ext']} groups {m['ext_groups']} "
            f"n_out {m['ext_n_out']} | demoted {m['demoted']} relocated "
            f"{m['relocated']} | tail {m['tail_nnz']} {m['tail_kind']} "
            f"panel_merge {m['panel_merge']}{streams}")


def one_call(name, prep, n, kernels, dev, calls=None):
    """The launches of each of ``kernels`` in one call of ``prep``, which
    must be exactly one each; with ``calls``, the port's kernel calls in
    that call must number ``calls``."""
    reset_counts()
    prep.fn(torch.as_tensor(make_x(n), dtype=torch.float32, device=dev))
    launched = counts()
    bad = {k: launched[k] for k in kernels if launched[k] != 1}
    if bad:
        raise AssertionError(f"{name}: launches in one call {bad}, "
                             "expected 1 each")
    total = sum(launched.values())
    if calls is not None and total != calls:
        raise AssertionError(f"{name}: {total} port kernel calls in one "
                             f"call, expected {calls} ({launched})")
    print(f"[{name}] one call: one launch each of {', '.join(kernels)} for "
          f"the {len(prep.mesh)} shards; {total} port kernel calls in all",
          flush=True)


def dist_phases(dev, card, flagship_A, PL):
    """Phases 22-27: the small row-sharded cases, cuda-chips and the split
    chips plan, then the row-sharded main paths (the PELL ones on
    powerlaw100k, ``PL``). Returns the kernel tables and counts of
    dist-flagship, dist-powerlaw100k-pell and its tile layout, which the
    kernels line reports."""
    # 22. the small row-sharded cases, all shards on one card
    launches = dict.fromkeys(DIST_KERNELS, 0)
    items = []
    for k in (2, 4):
        for name, (prep_fn, make, kw) in cases.DIST_CASES.items():
            if k == 2 and name.startswith("hybrid-chips"):
                continue        # both packages refuse: no tail on 2 shards
            if prep_fn == "prepare_row_sharded_pell":
                for layout in ("rows", "tiles"):
                    items.append((f"{name}-{k}-{layout}", make(k), prep_fn,
                                  {**kw, "layout": layout}, k))
                continue
            if prep_fn != "prepare_row_sharded_hybrid":
                items.append((f"{name}-{k}", make(k), prep_fn, kw, k))
                continue
            for layout in lane_ell.CORE_LAYOUTS:
                items.append((f"{name}-{k}-{layout}", make(k), prep_fn,
                              {**kw, "core_layout": layout}, k))
    make = cases.DIST_CASES["hybrid-chips-split"][1]
    items += [("amazon40k-ext-4-lanes", synth.amazon_csr(40_000, seed=11),
               "prepare_row_sharded_hybrid", {"core_layout": "lanes"}, 4),
              ("hybrid-chips-split-4-rows-hot", make(4),
               "prepare_row_sharded_hybrid",
               {"tail_kind": "chips-split", "chips_x": "hot"}, 4)]
    items += [(f"pell-rowsort1200-4-{layout}",
               synth.powerlaw_csr(1200, 1200, seed=21),
               "prepare_row_sharded_pell", {"layout": layout}, 4)
              for layout in ("rows", "tiles")]
    for name, A, prep_fn, kw, k in items:
        prep = getattr(distributed, prep_fn)(A, mesh=[dev] * k, **kw)
        x = make_x(A.n)
        xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
        before = counts()
        yk = prep.fn(xd)
        torch.cuda.synchronize()
        after = counts()
        for kname in DIST_KERNELS:
            launches[kname] += after[kname] - before[kname]
        rel_l2, row_rel, dmax = twin_check(A, x, yk, prep.plain(xd), name)
        rel_o = validate_result(spmv_oracle(A, x), to_numpy(yk),
                                what=f"{prep_fn} on {name}")
        calls = prep.kernel_calls(xd)
        errs = [check_call(kn, a, name) for kn, a in calls]
        print(f"[small-dist] {name}: nnz {A.nnz} | {dist_meta(prep)} | vs "
              f"plain rel-L2 {rel_l2:.3e} row {row_rel:.3e} max|d| "
              f"{dmax:.3e} | vs oracle rel {rel_o:.3e} | kernels "
              f"{[kn for kn, _ in calls]} each vs plain max|d| "
              f"{max(errs, default=0.0):.1e}", flush=True)
    require(launches, DIST_KERNELS, "small row-sharded cases")
    print(f"[small-dist] launches across the cases: {launches}", flush=True)
    small = [(f"chips-{name}", make(), "cuda-chips", {})
             for name, make in cases.CHIPS_CASES.items()]
    small.append(("heavy-scatter", cases.heavy_scatter(), "cuda-hybrid", {}))
    small_phase("small-chips", small, CHIPS_KERNELS,
                lambda p, A: f"{p.strategy} nnz {A.nnz} chips "
                f"{p.meta.get('tail_meta') or p.meta}", dev,
                "cuda-chips and the split chips plan")
    small_phase("small-chips-hot", [(f"{name}-hot", A, strategy,
                                     {**kw, "chips_x": "hot"})
                                    for name, A, strategy, kw in small],
                CHIPS_HOT_KERNELS, lambda p, A: f"{p.strategy} nnz {A.nnz}",
                dev, "cuda-chips and the split chips plan on chips_x='hot'")

    # 23-24. main paths 13 and 14: the flagship row-sharded on one card,
    # one shard on both core layouts (one pack) and four on the rows core
    knobs = {"loc_w": 256, "chunk": 24}
    hybrid = distributed.prepare_row_sharded_hybrid
    A = flagship_A
    *_, fl, fl_counts, rows1, _ = layouts_path(
        "dist-flagship", A, {**knobs, "mesh": [dev]}, dev, card,
        ("lane_rows",), ("lane_ell_sharded",),
        lambda m: m["tail_kind"] == "xla", "the segment-sum tail",
        describe=dist_meta)
    r1 = time_prepared(rows1, make_x(A.n))
    del rows1
    single = get_strategy("cuda-hybrid").prepare(A, device=dev, **knobs)
    r0 = time_prepared(single, make_x(A.n))
    print(f"[dist-flagship] cuda-hybrid, the same knobs, this run: call "
          f"{r0.duration_ms:.4f} ms (QT {single.meta['slots']}+"
          f"{single.meta['ov_slots']}) | the row-sharded call "
          f"{r1.duration_ms:.4f} ms: the distributed wrapper costs "
          f"{r1.duration_ms - r0.duration_ms:.4f} ms (both on the rows "
          f"core) | {card}", flush=True)
    del single
    _, _, prep4, _ = full_path(
        "dist-flagship-4x1", A, "row-sharded-hybrid",
        {**knobs, "mesh": [dev] * 4}, dev, card, ("lane_rows",),
        lambda m: m["tail_kind"] == "xla", "the segment-sum tail",
        describe=dist_meta, prepare=hybrid)
    one_call("dist-flagship-4x1", prep4, A.n, ("lane_rows",), dev)
    del prep4

    # 25. main path 15: webbase1m at mesh 1, the split chips plan, and the
    # chips and landing A/Bs; one segment-sum and one heavy_land a call
    # for all the streams
    WB = cases.webbase1m()
    *_, wb1, _ = layouts_path(
        "dist-webbase1m", WB, {"mesh": [dev]}, dev, card,
        ("lane_rows",) + CHIPS_KERNELS, ("lane_ell_sharded",) + CHIPS_KERNELS,
        lambda m: m["tail_kind"] == "chips-split", "the chips-split tail",
        describe=dist_meta, profile=True, forbid=GATHERS, chips=True,
        landing=True)
    one_call("dist-webbase1m", wb1, WB.n, DIST_CALL, dev, calls=4)
    del wb1, WB

    # 26. main path 16: amazon262k on four shards with idx8, and the
    # chips and landing A/Bs; one chips_products, one window_segsum and
    # one heavy_land launch a call for the four shards (four port kernel
    # calls a call)
    AZ = cases.amazon262k()
    *_, az4, _ = layouts_path(
        "dist-amazon262k-4x1", AZ, {"idx8": True, "mesh": [dev] * 4}, dev,
        card, ("lane_rows",) + CHIPS_KERNELS,
        ("lane_ell_sharded", "sorted_gather", "ranked_gather")
        + CHIPS_KERNELS,
        lambda m: (m["ext"] and m["tail_kind"] == "chips"
                   and m["panel_merge"] and m["idx8_planes"] > 0),
        "ext panels, chips tails, the panel merge and idx8",
        describe=dist_meta, profile=True, forbid=GATHERS,
        chips=True, landing=True)
    one_call("dist-amazon262k-4x1", az4, AZ.n, DIST_CALL, dev, calls=4)
    del az4, AZ

    # 27. main path 17: powerlaw100k through the row-sharded PELL on row
    # quanta, then on the tiles (the fused kernel and the un-permute),
    # the A/B of the two, then on four shards of the card
    pell_prep = distributed.prepare_row_sharded_pell
    dpl, dpl_counts, rows_prep, _ = full_path(
        "dist-powerlaw100k-pell", PL, "row-sharded-pell", {"mesh": [dev]},
        dev, card, ("pell_rows",), lambda m: m["layout"] == "rows",
        "the row-sharded PELL on row quanta", describe=dist_meta,
        prepare=pell_prep, forbid=("pell_fused", "unpermute"))
    dpt, dpt_counts, tiles_prep, _ = full_path(
        "dist-powerlaw100k-pell-tiles", PL, "row-sharded-pell",
        {"mesh": [dev], "layout": "tiles"}, dev, card,
        ("pell_fused", "unpermute"), lambda m: m["row_sort"],
        "the row-sorted fused PELL", describe=dist_meta, prepare=pell_prep,
        timing=False, forbid=("pell_rows",))
    layout_ab("dist-powerlaw100k-pell", tiles_prep, rows_prep,
              torch.as_tensor(make_x(PL.n), dtype=torch.float32, device=dev),
              card, old_kernels=("pell_fused", "unpermute"))
    del rows_prep, tiles_prep
    _, _, prep4, _ = full_path(
        "dist-powerlaw100k-pell-4x1", PL, "row-sharded-pell",
        {"mesh": [dev] * 4}, dev, card, ("pell_rows",),
        lambda m: m["layout"] == "rows", "the row-sharded PELL on row quanta",
        describe=dist_meta, prepare=pell_prep)
    one_call("dist-powerlaw100k-pell-4x1", prep4, PL.n, ("pell_rows",), dev)
    del prep4
    return fl, fl_counts, dpl, dpl_counts, dpt, dpt_counts


def tail_ab(name, old, new, xd, card):
    """Two big tails of one matrix through the hybrid (``old`` and
    ``new``: two packs that differ in ``tail_strategy``) in turns (old,
    new, new, old) in this run: each tail's kernel calls back to back
    (the core and the landing left out, the same on both), then the two
    whole calls the same way; beside them each tail's bound."""
    def tail_calls(prep):
        return [c for c in prep.kernel_calls(xd)
                if c[0] not in CORE_KERNELS + ("heavy_land",)]

    tails = {"old": tail_calls(old), "new": tail_calls(new)}
    kern = {"old": [], "new": []}
    call = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        kern[side].append(median_ms(run_calls(tails[side])))
    for side in ("old", "new", "new", "old"):
        call[side].append(call_ms((old if side == "old" else new).fn, xd))
    bounds = {side: sum(bound(k, a, KERNELS[k](*a))[0] for k, a in calls)
              for side, calls in tails.items()}

    def names(side):
        return "+".join(k for k, _ in tails[side])

    print(f"[{name}] tail A/B in turns (old, new, new, old): {names('old')} "
          f"{_ms(kern['old'])} ms, {names('new')} {_ms(kern['new'])} ms | "
          f"whole call, old {_ms(call['old'])} ms, new {_ms(call['new'])} ms"
          f" | bound: old {bounds['old']:.4f}, new {bounds['new']:.4f} ms | "
          f"{card}", flush=True)


def column_phases(dev, card, PL, pl_tiles_fill):
    """28-31: the branches the reference's PELL takes on the columns and
    the big tails through every f32 strategy. 28: ``banded3m3``, whose x
    is past the reference's budget, through ``spmv``'s auto route
    (``pick_auto`` must give ``cuda-pell``): the row layout, one
    ``pell_rows`` launch a call and no fused kernel; then
    ``banded3m3-tiles``, the reference's three column stripes, three
    ``pell_fused`` launches a call, and the A/B of the two layouts in
    turns. 29: ``powerlaw100k-hot``, the tiles with 2,048 hot columns,
    its fill beside the tiles' without the remap. 30: ``webbase1m-bcsr``,
    the hybrid with its big tail through ``pallas-bcsr`` (the bitmap
    tiles, landed by ``heavy_land``), then the tail A/B against the
    default compact-PELL tail in turns. 31: the small cases of the column
    branches (``cases.COLUMN_CASES`` on the tiles and on the rows) and of
    every reference tail name that runs (``cases.BIG_TAIL``). Returns the
    kernel tables and counts of 28 and 30."""
    A = cases.banded3m3()
    strategy = pick_auto(A)
    if strategy != "cuda-pell":
        raise AssertionError(f"banded3m3: pick_auto gave {strategy}")
    b3, b3_counts, rows, _ = full_path(
        "banded3m3", A, strategy, {}, dev, card, ("pell_rows",),
        lambda m: m.get("layout") == "rows" and m.get("stripes") == 0,
        "the row layout, no stripe, x past the 12 MB budget",
        forbid=("pell_fused",))
    xd = torch.as_tensor(make_x(A.n), dtype=torch.float32, device=dev)
    b3t, b3t_counts, tiles, _ = full_path(
        "banded3m3-tiles", A, "cuda-pell", {"layout": "tiles"}, dev, card,
        ("pell_fused",), lambda m: m.get("stripes") == 3,
        "three column stripes at the 12 MB budget", timing=False,
        forbid=("pell_rows",))
    for prep, want in ((rows, ["pell_rows"]), (tiles, ["pell_fused"] * 3)):
        got = [k for k, _ in prep.kernel_calls(xd)]
        if got != want:
            raise AssertionError(f"banded3m3: a call runs {got}, not {want}")
    layout_ab("banded3m3", tiles, rows, xd, card)
    del A, rows, tiles, xd

    _, _, hot, _ = full_path(
        "powerlaw100k-hot", PL, "cuda-pell",
        {"layout": "tiles", "hot_cols": 2048}, dev, card, ("pell_fused",),
        lambda m: m["hot_cols"] > 0, "hot columns", timing=False,
        forbid=("pell_rows",))
    print(f"[powerlaw100k-hot] fill {hot.meta['fill']:.4f} with "
          f"{hot.meta['hot_cols']} hot columns, {pl_tiles_fill:.4f} without "
          f"(the same tiles, powerlaw100k-tiles) | {card}", flush=True)
    del hot

    WB = cases.webbase1m()
    wbb, wbb_counts, new, _ = full_path(
        "webbase1m-bcsr", WB, "cuda-hybrid", {"tail_strategy": "pallas-bcsr"},
        dev, card, ("lane_rows", "bcsr_bits", "heavy_land"),
        lambda m: (m["tail_kind"] == "compact-cuda-bcsr-bits"
                   and m["tail_nnz"] > lane_ell.BIG_TAIL),
        "a compact BCSR tail (bitmap tiles) past BIG_TAIL",
        describe=pell_meta, forbid=GATHERS + ("pell_rows",))
    old = get_strategy("cuda-hybrid").prepare(WB, device=dev)
    xd = torch.as_tensor(make_x(WB.n), dtype=torch.float32, device=dev)
    tail_ab("webbase1m", old, new, xd, card)
    del WB, old, new, xd

    small = []
    for name, (spec, kw) in cases.COLUMN_CASES.items():
        A = cases.make(spec)
        small += [(f"{name}-tiles", A, "cuda-pell", {**kw, "layout": "tiles"}),
                  (f"{name}-rows", A, "cuda-pell", kw)]
    spec, kw = cases.BIG_TAIL
    A = cases.make(spec)
    small += [(f"amazon20k-tail-{name}", A, "cuda-hybrid",
               {**kw, "tail_strategy": name})
              for name in lane_ell.COMPACT_TAILS]
    small_phase("small-columns", small,
                ("pell_fused", "pell_rows", "lane_rows", "bcsr_bits",
                 "chips_products", "window_segsum", "heavy_land",
                 "xpose_s1_slots", "xpose_s3_rows"),
                column_small_meta, dev, "small column and tail cases")
    return b3, b3_counts, b3t, b3t_counts, wbb, wbb_counts


def scripts_phase(card):
    """33. The script harness as its users run it, in process: the batch
    driver (``scripts.results``) on the suite's first spec, twice
    (``-i 2``), every row validated (``--debug``), then the row-shard
    sweep (``scripts.scaling``) on the scaling suite's first matrix at 1
    and 4 shards of the card, every variant, every call validated; each
    with the launch counts set to 0 just before it and read just after,
    and its CSVs' rows and ids checked."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results")
        suite = results.SYNTH_SUITE
        results.SYNTH_SUITE = suite[:1]
        reset_counts()
        t0 = time.perf_counter()
        try:
            rc = results.main(["--synth-suite", "-o", out, "-i", "2",
                               "--debug", "--chunks", "64", "--bench",
                               "cuda-hybrid,cuda-pell,torch-csr-segsum"])
        finally:
            results.SYNTH_SUITE = suite
        launched = counts()
        require(launched, ("lane_rows", "pell_rows"), "scripts results")
        with open(os.path.join(out, "cuda.csv")) as f:
            ids = [ln.split(",")[2] for ln in f.read().splitlines()[1:]]
        if rc != 0 or sorted(ids) != sorted(["0", "11", "5"] * 2):
            raise AssertionError(f"scripts results: exit {rc}, ids {ids}")
        print(f"[scripts results] {suite[0]} -i 2: exit {rc}, cuda.csv "
              f"ids {ids}, {time.perf_counter() - t0:.1f} s | launches "
              f"{ {k: v for k, v in launched.items() if v} } | {card}",
              flush=True)

        out = os.path.join(tmp, "scaling")
        spec = scaling.SUITE[0][0]
        reset_counts()
        t0 = time.perf_counter()
        rc = scaling.main(["-o", out, "-m", spec, "--devices", "1,4",
                           "--pell", "--hybrid"])
        launched = counts()
        require(launched, ("lane_rows", "pell_rows"), "scripts scaling")
        with open(os.path.join(out, "omp.csv")) as f:
            rows = [ln.split(",") for ln in f.read().splitlines()[1:]]
        cells = [(r[2], r[7]) for r in rows]
        want = [(b, k) for b in ("mesh_rowshard", "mesh_rowshard_pell",
                                 "mesh_rowshard_hybrid") for k in ("1", "4")]
        if rc != 0 or cells != want:
            raise AssertionError(f"scripts scaling: exit {rc}, {cells}")
        print(f"[scripts scaling] {spec} at 1 and 4 shards of the card: "
              + ", ".join(f"{r[2]} x{r[7]} {float(r[8]):.4f} ms" for r in rows)
              + f" | {time.perf_counter() - t0:.1f} s | launches "
              f"{ {k: v for k, v in launched.items() if v} } | {card}",
              flush=True)
    print(f"[scripts] phase {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)


def cli_run(tag, argv, card):
    """One in-process run of the port's CLI (``cli.run``), the launch
    counts set to 0 just before it and read just after. It must exit 0,
    every row must have passed ``-d``, and every skipped cell must be a
    refusal (``ValueError`` / ``NotImplementedError``); each row and each
    skipped cell is printed. Returns (the run, its counts)."""
    reset_counts()
    t0 = time.perf_counter()
    done = cli.run(argv)
    secs = time.perf_counter() - t0
    launched = counts()
    if done.code != 0:
        raise AssertionError(f"[cli {tag}] exit {done.code}")
    for r in done.results:
        if r.rel_err is None:
            raise AssertionError(f"[cli {tag}] {r.strategy} not validated")
        print(f"[cli {tag}] {r.strategy} chunk {r.chunk} "
              f"{r.bench.duration_ms:.4f} ms {r.bench.gflops:.2f} GFLOP/s "
              f"rel_err {r.rel_err:.3e} | {card}", flush=True)
    for name, chunk, why in done.cfg.skipped:
        print(f"[cli {tag}] skipped {name} (chunk={chunk}): {why}",
              flush=True)
        if not why.startswith(tuple(f"refused ({e.__name__})"
                                    for e in REFUSALS)):
            raise AssertionError(f"[cli {tag}] {name}: not a refusal")
    print(f"[cli {tag}] {secs:.1f} s, {len(done.results)} rows, "
          f"{len(done.cfg.skipped)} skipped | launches "
          f"{ {k: v for k, v in launched.items() if v} } | {card}",
          flush=True)
    return done, launched


def check_csvs(tag, out, done, runs=1):
    """The CSVs of ``runs`` identical CLI runs into ``out``: each file has
    the JAX package's header once (``logger._HEADERS``, held equal to it
    by the tests), ``runs`` times the run's rows, and every ``kernel`` id
    is one of the JAX package's (``logger.REF_IDS``)."""
    rows = {"serial": 0, "omp": 0, "cuda": 0}
    for r in done.results:
        kind = ("serial" if r.strategy.startswith("oracle-") else
                "omp" if "@" in r.strategy else "cuda")
        rows[kind] += 1
    for kind, header in logger._HEADERS.items():
        with open(os.path.join(out, f"{kind}.csv")) as f:
            lines = f.read().splitlines()
        if lines[0] != header or lines.count(header) != 1 \
                or len(lines) != 1 + runs * rows[kind]:
            raise AssertionError(f"[cli {tag}] {kind}.csv: header "
                                 f"{lines[0]!r}, {len(lines)} lines")
        if kind == "cuda":
            ids = {ln.split(",")[2] for ln in lines[1:]}
            if not ids <= {str(i) for i in logger.REF_IDS.values()}:
                raise AssertionError(f"[cli {tag}] kernel ids {ids}")
    print(f"[cli {tag}] CSVs: the reference's headers once, {rows} rows a "
          f"run x {runs}, kernel ids the JAX package's", flush=True)


def cli_phase(card, amz_call_ms):
    """28. The port's CLI as its users run it, in process: (a) the
    amazon262k stand-in written as a ``.mtx``, parsed by the native parser
    into the layout cache, every registered torch and cuda SpMV strategy
    at chunk 64 with ``-d``, the row shards, the SpMM at 8 columns and the
    native OpenMP sweep; then the same command again, which must read the
    cache without parsing and append under the single headers; (b) the
    stencil48k spec through the hybrid, its fp64 grade and BCSR, the SpMM
    at 8 and 64 columns."""
    if not (native.available() and native_omp.available()):
        raise AssertionError("cli: the native parser or the OpenMP kernels "
                             "did not build (g++)")
    spmv_names = [n for n in list_strategies()
                  if get_strategy(n).backend in ("torch", "cuda")
                  and not get_strategy(n).spmm_only]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        A = cases.amazon262k()
        path = os.path.join(tmp, "amazon262k.mtx")
        t0 = time.perf_counter()
        mmio.write(path, A.m, A.n, A.row_ids(), A.ja, A.as_)
        print(f"[cli a] amazon262k.mtx: nnz {A.nnz}, "
              f"{os.path.getsize(path)} B written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = os.path.join(tmp, "res-a")
        argv = ["-m", path, "-o", out, "-d", "--chunks", "64",
                "--distributed", "--spmm-cols", "8", "--host-parallel",
                "-b", ",".join(spmv_names)]
        native.PARSES = 0
        first, launched = cli_run("a", argv, card)
        if native.PARSES != 1 or not os.path.exists(cache.cache_path(path)):
            raise AssertionError(f"cli (a): {native.PARSES} native parses, "
                                 "cache written: "
                                 f"{os.path.exists(cache.cache_path(path))}")
        require(launched, ("lane_rows", "chips_products", "window_segsum",
                           "heavy_land", "pell_rows"), "cli (a)")
        check_csvs("a", out, first)
        native.PARSES = 0
        second, _ = cli_run("a-cached", argv, card)
        if native.PARSES != 0:
            raise AssertionError("cli (a) again: parsed instead of reading "
                                 "the layout cache")
        check_csvs("a-cached", out, second, runs=2)
        hybrid = next(r for r in first.results
                      if r.strategy == "cuda-hybrid")
        print(f"[cli a] runner's cuda-hybrid row (chunk {hybrid.chunk}) "
              f"{hybrid.bench.duration_ms:.4f} ms against this run's "
              f"amazon262k path call (default chunk) {amz_call_ms:.4f} ms: "
              f"ratio {hybrid.bench.duration_ms / amz_call_ms:.3f} (both "
              f"time_prepared of the same call) | {card}", flush=True)

        out = os.path.join(tmp, "res-b")
        done, launched = cli_run("b", [
            "-m", "synth:stencil:m=48000,points=6,run_len=12,bandwidth=500,"
            "seed=3", "-o", out, "-b", "cuda-hybrid,cuda-hybrid-fp64,cuda-bcsr",
            "-d", "--chunks", "64", "--spmm-cols", "8,64"], card)
        require(launched, ("bcsr_bits", "bcsr_bits_spmm", "lane_ell_fp64"),
                "cli (b)")
        check_csvs("b", out, done)
    print(f"[cli] phase {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "card", file=sys.stderr)
        return 2
    dev = cuda_device()
    hybrid = get_strategy("cuda-hybrid")

    # 1. device
    card = card_label()
    nvcc = subprocess.run([_kernels.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc: {release[-1].strip()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _kernels.build_all()
    for name in _kernels.SIGNATURES:
        _kernels.load(name)
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{', '.join(p.name for p in libs)}", flush=True)

    # 3. the small cases on both core layouts: call against plain call
    # and oracle, each kernel call replayed against its plain version
    small_phase("small", [
        (f"{name}-{layout}", make(), "cuda-hybrid",
         {**kw, "core_layout": layout})
        for name, (make, kw) in cases.SMALL_CASES.items()
        for layout in lane_ell.CORE_LAYOUTS], HYBRID_KERNELS,
        hybrid_small_meta, dev, "small cases")

    # 4. the stream probe and the grid-stride kernel against their plain
    # version, then each as measure_stream_bw runs it (counts set to 0
    # just before and read just after), then the two and sum in turns
    buf = torch.ones(roof.PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    want = float(buf.numel() // roof.TILE)
    entries = {"stream_reduce": roof.stream_reduce,
               "stream_reduce_strided": roof.stream_reduce_strided}
    probes, probe_counts, bws = {}, {}, {}
    for name, fn in entries.items():
        got, plain = fn(buf), roof.stream_reduce_plain(buf)
        if not (torch.equal(got, plain) and bool((got == want).all())):
            raise AssertionError(f"{name} disagrees with its plain version")
        probes[name] = {"max_abs_err": float((got - plain).abs().max()),
                        "plain_ms": call_ms(roof.stream_reduce_plain, buf),
                        "library_ms": None, "ms": None}
        probes[name]["bound_ms"], probes[name]["bound_by"] = bound(
            name, (buf,), got)
        reset_counts()
        bws[name] = roof.measure_stream_bw(dev, reduce=fn)
        probe_counts[name] = counts()
        require(probe_counts[name], (name,), f"measure_stream_bw ({name})")
    turns = {k: [] for k in (*entries, "sum")}
    order = (*entries, "sum")
    for k in order + order[::-1]:
        turns[k].append(median_ms(entries.get(k, lambda b: b.sum()), buf))
    for name in entries:
        probes[name]["ms"] = float(np.mean(turns[name]))
        probes[name]["library_ms"] = float(np.mean(turns["sum"]))
    del buf

    def gbs(ms):
        return roof.PROBE_BYTES / (ms * 1e-3) / 1e9

    print(f"[probe] {roof.PROBE_BYTES} B, exact match ({want:.0f} per "
          f"position) on both | in turns (probe, strided, sum, sum, "
          f"strided, probe): stream_reduce "
          f"{', '.join(f'{t:.4f}' for t in turns['stream_reduce'])} ms = "
          f"{gbs(probes['stream_reduce']['ms']):.1f} GB/s, "
          f"stream_reduce_strided "
          f"{', '.join(f'{t:.4f}' for t in turns['stream_reduce_strided'])}"
          f" ms = {gbs(probes['stream_reduce_strided']['ms']):.1f} GB/s, sum "
          f"{', '.join(f'{t:.4f}' for t in turns['sum'])} ms = "
          f"{gbs(probes['stream_reduce']['library_ms']):.1f} GB/s | "
          f"measure_stream_bw: {bws['stream_reduce']:.1f} GB/s, strided "
          f"{bws['stream_reduce_strided']:.1f} GB/s | plain "
          f"{probes['stream_reduce']['plain_ms']:.4f} ms | bound "
          f"{probes['stream_reduce']['bound_ms']:.4f} ms | {card}",
          flush=True)

    # 5. main path 1: the flagship on the rows core, then the lanes core
    # of the same pack, then the A/B of the two
    A = cases.flagship()
    x = make_x(A.n)
    gold = spmv_oracle(A, x)
    reset_counts()
    t0 = time.perf_counter()
    preps = lane_ell.prepare_hybrid_layouts(A, device="cuda",
                                            **cases.FLAGSHIP_KNOBS)
    prep = preps["rows"]
    pack_s = time.perf_counter() - t0
    rel_o = validate_result(gold, to_numpy(prep.fn(x)),
                            what="cuda-hybrid on the flagship")
    r = time_prepared(prep, x)
    validate_result(gold, r.data, what="cuda-hybrid timed run")
    rep = roof.roofline(prep, r.duration_ms, r.gflops, x_bytes=A.n * 4,
                        y_bytes=A.m * 4)
    flag_counts = counts()
    require(flag_counts, ("lane_rows", "stream_reduce"), "flagship")

    m = prep.meta
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rel_l2, row_rel, _ = twin_check(A, x, prep.fn(xd), prep.plain(xd),
                                    "flagship")
    flag = kernel_table(prep, xd, "flagship", A=A)["lane_rows"]
    print(f"[flagship] nnz {A.nnz} pack {pack_s:.1f} s (both layouts) | "
          f"loc_w {m['loc_w']} Q {m['slots']}+{m['ov_slots']} idx8 "
          f"{m['idx8_planes']} chunk {m['chunk']} steps {m['steps']} tail "
          f"{m['tail_nnz']} fill {m['fill']:.3f} hbm_bytes {prep.hbm_bytes}"
          f" | vs oracle rel {rel_o:.3e} | vs plain rel-L2 {rel_l2:.3e} "
          f"row {row_rel:.3e} core max|d| {flag['max_abs_err']:.3e}",
          flush=True)
    print(f"[flagship] call {r.duration_ms:.4f} ms = {r.gflops:.2f} "
          f"GFLOP/s | kernel lane_rows {flag['ms']:.4f} ms = "
          f"{2 * A.nnz / flag['ms'] / 1e6:.2f} GFLOP/s | plain "
          f"{flag['plain_ms']:.4f} ms | bound {flag['bound_ms']:.4f} ms "
          f"(format-free {flag['free_ms']:.4f}) | cuSPARSE CSR of the "
          f"core's entries {flag['library_ms']:.4f} ms | stream "
          f"{rep.stream_bw_gbs:.1f} GB/s vs_roofline {rep.fraction:.4f} "
          f"vs_ideal_roofline {rep.fraction_ideal:.4f} | launches "
          f"{flag_counts} | {card}", flush=True)
    lanes = preps["lanes"]
    reset_counts()
    rel_lo = validate_result(gold, to_numpy(lanes.fn(x)),
                             what="cuda-hybrid (lanes) on the flagship")
    rl = time_prepared(lanes, x)
    validate_result(gold, rl.data, what="cuda-hybrid (lanes) timed run")
    flag_lanes_counts = counts()
    require(flag_lanes_counts, ("lane_ell_spmv",), "flagship-lanes")
    rel_l2, row_rel, _ = twin_check(A, x, lanes.fn(xd), lanes.plain(xd),
                                    "flagship-lanes")
    flag_lanes = kernel_table(lanes, xd, "flagship-lanes",
                              A=A)["lane_ell_spmv"]
    print(f"[flagship-lanes] call {rl.duration_ms:.4f} ms = "
          f"{rl.gflops:.2f} GFLOP/s | kernel lane_ell_spmv "
          f"{flag_lanes['ms']:.4f} ms | plain {flag_lanes['plain_ms']:.4f} "
          f"ms | bound {flag_lanes['bound_ms']:.4f} ms | cuSPARSE CSR of "
          f"the whole matrix {flag_lanes['library_ms']:.4f} ms | hbm_bytes "
          f"{lanes.hbm_bytes} | vs oracle rel {rel_lo:.3e} | vs plain rel-L2"
          f" {rel_l2:.3e} row {row_rel:.3e} | launches {flag_lanes_counts} "
          f"| {card}", flush=True)
    core_ab("flagship", prep, lanes, xd, A, card)
    del preps, prep, lanes, xd
    flagship_A = A

    # 6. main path 2: amazon262k, the ext route (lanes core) and the
    # chips tail, then the chips A/B
    amz, amz_counts, amz_lanes, amz_lanes_counts, _, amz_r = layouts_path(
        "amazon262k", cases.amazon262k(), {}, dev, card,
        ("lane_rows",) + CHIPS_KERNELS,
        ("lane_ell_spmv", "sorted_gather", "ranked_gather") + CHIPS_KERNELS,
        lambda m: m["ext"] and m["tail_kind"] == "chips",
        "the ext route and the chips tail", forbid=GATHERS,
        chips=True, landing=True,
        describe=lambda p: (
            f"loc_w {p.meta['loc_w']} Q {p.meta['slots']}+"
            f"{p.meta['ov_slots']} chunk {p.meta['chunk']} steps "
            f"{p.meta['steps']} | ext {p.meta['ext']} ext_h "
            f"{p.meta['ext_h']} ext_windowed {p.meta['ext_windowed']} "
            f"ext_groups {p.meta['ext_groups']} ext_cov {p.meta['ext_cov']}"
            f" | tail_nnz {p.meta['tail_nnz']} tail_kind "
            f"{p.meta['tail_kind']} chips {p.meta['tail_meta']}"),
        profile=True)

    # 7. main path 3: the windowed stage 2 (lanes core) at full size
    *_, win, win_counts, _, _ = layouts_path(
        "ext_windowed1m", cases.ext_windowed1m(), {}, dev, card,
        ("lane_rows",), ("lane_ell_spmv", "sorted_gather", "window_gather"),
        lambda m: m["ext_windowed"], "the windowed stage 2",
        describe=lambda p: (
            f"ext_h {p.meta['ext_h']} r_hot {p.meta['ext_r_hot']} "
            f"ext_groups {p.meta['ext_groups']} ext_cov {p.meta['ext_cov']} "
            f"tail {p.meta['tail_nnz']} {p.meta['tail_kind']}"))

    # 8. the small PELL cases: each at its default layout, and the fused
    # ones on the tile layout too
    small = [(name, make(), strategy, kw) for name, (make, strategy, kw)
             in cases.PELL_CASES.items()]
    small += [(f"{name}-tiles", A, strategy, {**kw, "layout": "tiles"})
              for name, A, strategy, kw in small
              if strategy == "cuda-bcsr" or (
                  strategy == "cuda-pell"
                  and kw.get("scheme") not in ("span", "pure"))]
    small += [(name, make(), "cuda-bcsr", {})
              for name, make in cases.BITS_CASES.items()]
    small_phase("small-pell", small, PELL_KERNELS, pell_small_meta, dev,
                "small PELL cases")

    # 9-12. the PELL family at full size: two main paths through the
    # hybrid (each beside its tile layout, in turns), then the span scheme
    # and BCSR
    PL = cases.powerlaw100k()
    pw, pw_counts, pw_prep, _ = full_path(
        "powerlaw100k", PL, "cuda-hybrid", {}, dev, card, ("pell_rows",),
        lambda m: (m.get("delegated") == "cuda-pell"
                   and m["layout"] == "rows"),
        "the no-locality escape to cuda-pell (row layout)")
    xd = torch.as_tensor(make_x(PL.n), dtype=torch.float32, device=dev)
    old = get_strategy("cuda-pell").prepare(PL, device=dev, layout="tiles")
    layout_ab("powerlaw100k", old, pw_prep, xd, card)
    pl_tiles_fill = old.meta["fill"]
    del old, pw_prep
    WB = cases.webbase1m()
    *_, wb_prep, _ = layouts_path(
        "webbase1m", WB, {}, dev, card, ("lane_rows", "pell_rows",
                                         "heavy_land"),
        ("lane_ell_spmv", "pell_rows", "heavy_land"),
        lambda m: (m["tail_kind"] == "compact-cuda-pell-rows"
                   and m["tail_nnz"] > lane_ell.BIG_TAIL),
        "a compact-PELL tail (row layout) past BIG_TAIL", describe=pell_meta,
        forbid=GATHERS, landing=True)
    xd = torch.as_tensor(make_x(WB.n), dtype=torch.float32, device=dev)
    old = hybrid.prepare(WB, device=dev, pell_layout="tiles")
    layout_ab("webbase1m-tail", old, wb_prep, xd, card)
    del old, wb_prep, xd, WB
    sp, sp_counts, *_ = full_path(
        "powerlaw100k-span", PL, "cuda-pell",
        {"scheme": "span"}, dev, card, ("pell_tiles", "span_segsum"),
        lambda m: m["scheme"] == "span", "the span scheme", timing=False)
    bc, bc_counts, *_ = bcsr_paths(
        "flagship-bcsr", flagship_A, "cuda-bcsr", {}, dev, card, "bcsr_bits",
        ("pell_tiles", "window_segsum"), pell_meta)

    wx, wx_counts, ws, ws_counts, wp, wp_counts = xpose_phases(dev, card)
    (fl64, fl64_counts, pw64, pw64_counts, pt64, pt64_counts, sp8,
     sp8_counts, st8, st8_counts) = fp64_spmm_phases(dev, card, flagship_A,
                                                     PL)
    dfl, dfl_counts, dpl, dpl_counts, dpt, dpt_counts = dist_phases(
        dev, card, flagship_A, PL)
    del flagship_A
    b3, b3_counts, b3t, b3t_counts, wbb, wbb_counts = column_phases(
        dev, card, PL, pl_tiles_fill)
    del PL
    cli_phase(card, amz_r.duration_ms)
    scripts_phase(card)

    # the kernels line: each kernel timed on the path that runs it, as
    # (its row, the path's counts, the path), in LINE_ORDER's order
    measured = {
        "lane_ell_spmv": [(flag_lanes, flag_lanes_counts, "flagship-lanes")],
        "lane_ell_sharded": [(dfl["lane_ell_sharded"], dfl_counts,
                              "dist-flagship-lanes")],
        "lane_rows": [(flag, flag_counts, "flagship")],
        "stream_reduce": [(probes["stream_reduce"], flag_counts,
                           "flagship")],
        "stream_reduce_strided": [(probes["stream_reduce_strided"],
                                   probe_counts["stream_reduce_strided"],
                                   "measure_stream_bw")],
        "sorted_gather": [(amz_lanes["sorted_gather"], amz_lanes_counts,
                           "amazon262k-lanes")],
        "ranked_gather": [(amz_lanes["ranked_gather"], amz_lanes_counts,
                           "amazon262k-lanes")],
        "chips_products": [(amz["chips_products"], amz_counts,
                            "amazon262k")],
        "window_segsum": [(amz["window_segsum"], amz_counts, "amazon262k")],
        "heavy_land": [(amz["heavy_land"], amz_counts, "amazon262k"),
                       (wbb["heavy_land"], wbb_counts, "webbase1m-bcsr")],
        "window_gather": [(win["window_gather"], win_counts,
                           "ext_windowed1m-lanes")],
        "pell_fused": [(dpt["pell_fused"], dpt_counts,
                        "dist-powerlaw100k-pell-tiles"),
                       (b3t["pell_fused"], b3t_counts, "banded3m3-tiles")],
        "unpermute": [(dpt["unpermute"], dpt_counts,
                       "dist-powerlaw100k-pell-tiles")],
        "pell_rows": [(pw["pell_rows"], pw_counts, "powerlaw100k"),
                      (dpl["pell_rows"], dpl_counts,
                       "dist-powerlaw100k-pell"),
                      (b3["pell_rows"], b3_counts, "banded3m3")],
        "pell_rows_fp64": [(pw64["pell_rows_fp64"], pw64_counts,
                            "powerlaw100k-fp64")],
        "pell_tiles": [(sp["pell_tiles"], sp_counts, "powerlaw100k-span")],
        "span_segsum": [(sp["span_segsum"], sp_counts, "powerlaw100k-span")],
        **{k: [(wx[k], wx_counts, "webbase1m-xpose")]
           for k in XPOSE_KERNELS},
        **{k: [(ws[k], ws_counts, "webbase1m-xpose-slab")]
           for k in ("xpose_mirror", "xpose_s1")},
        "xpose_s3": [(wp["xpose_s3"], wp_counts, "webbase1m-xpose-prefix")],
        "lane_ell_fp64": [(fl64["lane_ell_fp64"], fl64_counts,
                           "flagship-fp64")],
        "pell_fused_fp64": [(pt64["pell_fused_fp64"], pt64_counts,
                             "powerlaw100k-fp64-tiles")],
        "bcsr_spmm": [(st8["bcsr_spmm"], st8_counts,
                       "flagship-spmm8-tiles")],
        "bcsr_bits": [(bc["bcsr_bits"], bc_counts, "flagship-bcsr"),
                      (wbb["bcsr_bits"], wbb_counts, "webbase1m-bcsr")],
        "bcsr_bits_spmm": [(sp8["bcsr_bits_spmm"], sp8_counts,
                            "flagship-spmm8")]}
    line = []
    for name in LINE_ORDER:
        row, launched, path = measured[name].pop(0)
        src, replaces = SOURCES[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "path": path,
                     "launches": launched[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
