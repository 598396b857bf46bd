"""The process environment of every run, set before torch is imported."""

import os
from pathlib import Path


def configure(root: Path) -> None:
    # annotation timestamps are local time in this zone (crane-scheduler's
    # wire format); the port reads TZ, the benchmark writes in the same zone
    os.environ["TZ"] = "Asia/Shanghai"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["CRANE_TELEMETRY"] = "0"  # the port's own spans stay off in the benchmark
    # one process with one intra-op thread: the scheduler's host path is one
    # Python thread, and idle pool threads on a shared host only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # kernel caches at fixed paths inside the checkout (the port builds its
    # CUDA kernels into crane_scheduler_tpu_torch/_build by itself)
    os.environ["TRITON_CACHE_DIR"] = str(root / ".portbench_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / ".portbench_cache" / "torch_extensions")
