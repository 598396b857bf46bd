"""The port's binding of the host library (``csrc/crane_native.cpp``,
``csrc/crane_pylist.cpp``).

Counterpart of ``crane_scheduler_tpu/native/``: ``lib`` (build at first use
and load), ``codec`` (bulk annotation parse, value parse, 5-decimal
render), ``bindings`` (the C++ binding heap), ``listdecode`` (the LIST and
watch decoders, with the Python twin) and ``httpflush`` (the GIL-free HTTP
flush engines).
"""

from .bindings import NativeBindingRecords
from .codec import bulk_parse_annotations
from .lib import load_native, load_pylist

__all__ = [
    "load_native",
    "load_pylist",
    "NativeBindingRecords",
    "bulk_parse_annotations",
]
