"""Serving: registry, admission, micro-batching, paged decode and HTTP."""
from .admission import AdmissionController, RejectedError, normalize_priority
from .batcher import MicroBatcher, batch_bucket
from .decode import DecodeEngine, DecodeSession
from .paging import PagePool
from .registry import ModelRegistry, ModelVersion
from .serving import InferenceServer

__all__ = ["AdmissionController", "DecodeEngine", "DecodeSession",
           "InferenceServer", "MicroBatcher", "ModelRegistry", "ModelVersion",
           "PagePool", "RejectedError", "batch_bucket", "normalize_priority"]
