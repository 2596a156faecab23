"""The benchmark of ``chowdsp_fft_tpu_torch`` on an NVIDIA H100.

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. This package
holds the yardstick (traffic generation, the roofline arithmetic, the
float64 references and the comparison that decides ``correct``, the
per-layer metric readers) and takes from the port only the system under
test, its launch counters and its kernel names.
"""
