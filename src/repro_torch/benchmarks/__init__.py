"""The paper's single-GPU microbenchmarks on one H100.

Counterpart of the reference's root ``benchmarks/`` folder, module for
module: ``bench_membw`` (Figs. 2, 7, 8), ``bench_copy`` (Figs. 5, 9, 10),
``bench_latency`` (Figs. 11, 12), ``bench_gemm`` (Figs. 15, 16, Table III)
and ``bench_managed_vs_system`` (Fig. 4), run by
``python -m repro_torch.benchmarks.run``.  Each prints the reference's
``name,us_per_call,derived`` rows: measured rows on the device it runs on
(``cuda`` by default), ``analytic`` rows from the datapath model under the
active :class:`~repro_torch.core.hardware.SystemSpec` (the H100 spec
sheet unless a calibration is activated).
"""
