"""The benchmark of ``spmv_scpa_tpu_torch`` on NVIDIA cards.

``python -m spmv_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line (see ``README.md``). Everything the yardstick computes with lives
here, frozen: the matrix generators, the plain fp64 reference, the timing
methods and the roofline arithmetic. From the port it takes only the
system under test (``registry.pick_auto``, ``get_strategy``, the
``Prepared`` call), its launch counters and its kernel names.
"""
