from .codec import (
    encode_annotation,
    decode_annotation,
    decode_annotation_or_missing,
    bulk_decode_annotations,
    go_parse_float,
    format_metric_value,
)
from .store import NodeLoadStore, DeviceSnapshot

__all__ = [
    "encode_annotation",
    "decode_annotation",
    "decode_annotation_or_missing",
    "bulk_decode_annotations",
    "go_parse_float",
    "format_metric_value",
    "NodeLoadStore",
    "DeviceSnapshot",
]
