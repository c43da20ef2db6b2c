"""Serving: registry, admission, micro-batching, paged and LSTM decode,
streaming sessions and HTTP."""
from .admission import AdmissionController, RejectedError, normalize_priority
from .batcher import MicroBatcher, batch_bucket
from .decode import DecodeEngine, DecodeSession
from .paging import PagePool
from .registry import ModelRegistry, ModelVersion
from .serving import InferenceServer
from .streaming import StreamSessions

__all__ = ["AdmissionController", "DecodeEngine", "DecodeSession",
           "InferenceServer", "MicroBatcher", "ModelRegistry", "ModelVersion",
           "PagePool", "RejectedError", "StreamSessions", "batch_bucket",
           "normalize_priority"]
