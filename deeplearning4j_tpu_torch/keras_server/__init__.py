"""Serving: registry, admission, micro-batching, replicas behind a router,
the autoscaler, paged, LSTM and speculative decode, streaming sessions,
HTTP and the load generator."""
from .admission import AdmissionController, RejectedError, normalize_priority
from .autoscaler import Autoscaler
from .batcher import MicroBatcher, batch_bucket
from .decode import DecodeEngine, DecodeSession
from .loadgen import (
    run_ab, run_closed_loop, run_decode_ab, run_open_loop, run_paged_ab,
    run_ramp_ab, run_replica_ab, run_spec_ab, run_token_stream_load,
)
from .paging import PagePool
from .registry import (
    ModelRegistry, ModelVersion, global_model_registry,
    set_global_model_registry,
)
from .replica import Replica, ReplicaSet
from .serving import InferenceServer
from .streaming import StreamSessions

__all__ = ["AdmissionController", "Autoscaler", "DecodeEngine",
           "DecodeSession", "InferenceServer", "MicroBatcher",
           "ModelRegistry", "ModelVersion", "PagePool", "RejectedError",
           "Replica", "ReplicaSet", "StreamSessions", "batch_bucket",
           "global_model_registry", "normalize_priority", "run_ab",
           "run_closed_loop", "run_decode_ab", "run_open_loop",
           "run_paged_ab", "run_ramp_ab", "run_replica_ab", "run_spec_ab",
           "run_token_stream_load", "set_global_model_registry"]
