"""The node annotator: metric sync into ``value,timestamp`` annotations,
and bind events into hot values.

Counterpart of ``crane_scheduler_tpu/annotator/__init__.py``.
"""

from .bindings import Binding, BindingRecords
from .events import translate_event_to_binding, EventIngestor
from .workqueue import RateLimitedQueue
from .controller import NodeAnnotator, AnnotatorConfig

__all__ = [
    "Binding",
    "BindingRecords",
    "translate_event_to_binding",
    "EventIngestor",
    "RateLimitedQueue",
    "NodeAnnotator",
    "AnnotatorConfig",
]
