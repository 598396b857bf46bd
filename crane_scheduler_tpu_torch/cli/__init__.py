"""Command-line entry points of the port (``python -m
crane_scheduler_tpu_torch.cli.<name>``). Counterpart of
``crane_scheduler_tpu/cli``; only ``service_main`` (crane-scorer) is
ported so far."""
