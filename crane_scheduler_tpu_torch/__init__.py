"""PyTorch/CUDA port of ``crane_scheduler_tpu``.

The burst-scheduling path (fused Dynamic filter+score, water-filling gang
solve, columnar bind) runs on an NVIDIA GPU through PyTorch and two CUDA
kernels written for Hopper (``csrc/``); the per-pod drip path
(``framework.scheduler.Scheduler``) runs its batched windows there through
PyTorch; the scoring sidecar (``service``, ``cli.service_main``) serves
both kernels over HTTP. The package imports neither JAX
nor ``crane_scheduler_tpu``; the host modules it needs are its own copies.

Entry points take a ``device`` argument; ``None`` means ``"cuda"`` and
raises when no GPU is present. Pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels on the CPU.
"""

__version__ = "0.1.0"
