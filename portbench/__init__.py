"""The benchmark of the PyTorch/CUDA port (``crane_scheduler_tpu_torch``).

One command runs one cell once::

    python3 portbench/run.py --workload drip-65k --seed 7 --seconds 30 --trace 0

Everything that measures lives here and is frozen: the traffic generator,
the cluster builder, the profiler reduction, the table of peaks with the
kernels' operation and byte counts, the plain reference and the comparison
that decides ``correct``. From the port the benchmark takes only its entry
points, its counters and the names of its kernels.
"""
