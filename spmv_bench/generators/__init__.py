"""Matrix generators, one module a generator, each with ``build(**args)
-> csr.Matrix``; a configuration names its module by ``generator`` and
passes its ``args``. Frozen copies of the port's ``testing`` generators:
the same arguments give the same arrays (``tests/test_spmv_bench_frozen.py``
holds them equal today), and no later change to the port moves them.
"""
