"""The registry of telemetry metric names: the ``/metrics`` stability contract.

Counterpart of ``deeplearning4j_tpu/observability/names.py``, with the same
strings: a scraper, alert or dashboard written against either package reads
the other's series. Every name lives here once, as a ``dl4j_``-prefixed
constant; call sites import the constant instead of repeating the string.
The port records the serving, training, parallel and data paths' series
(A9.1), the span, trace and SLO series (A9.2) and the flight recorder's and
health monitor's (A9.3); the rest are defined here for the modules that
will record them (A9.4).

Naming follows Prometheus conventions: ``_total`` for counters, ``_seconds``
/ ``_bytes`` for unit-carrying series, no label names in the metric name.
"""
from __future__ import annotations

# --- spans (observability/spans.py) ----------------------------------------
SPAN_SECONDS = "dl4j_span_seconds"

# --- compile tracking (observability/compile_tracker.py) -------------------
JIT_COMPILE_TOTAL = "dl4j_jit_compile_total"
JIT_COMPILE_SECONDS = "dl4j_jit_compile_seconds"
JIT_BACKEND_COMPILE_SECONDS = "dl4j_jit_backend_compile_seconds"
RECOMPILE_STORM_WARNINGS_TOTAL = "dl4j_recompile_storm_warnings_total"

# --- per-iteration telemetry (observability/listener.py) -------------------
DEVICE_HBM_BYTES = "dl4j_device_hbm_bytes"
DEVICE_HBM_PEAK_BYTES = "dl4j_device_hbm_peak_bytes"
STEP_HOST_SECONDS = "dl4j_step_host_seconds"
STEP_DEVICE_SYNC_SECONDS = "dl4j_step_device_sync_seconds"
TRAIN_SCORE = "dl4j_train_score"
TRAIN_ITERATION = "dl4j_train_iteration"

# --- fit-loop phase attribution (nn/multilayer.py, parallel/wrapper.py) ----
FIT_PHASE_SECONDS = "dl4j_fit_phase_seconds"

# --- collective traffic (parallel/{wrapper,training_master,moe,ring_attention}.py)
COLLECTIVE_BYTES_TOTAL = "dl4j_collective_bytes_total"
COLLECTIVE_BYTES_PER_STEP = "dl4j_collective_bytes_per_step"

# --- sharding engine (parallel/{partition,compile_seam}.py) ----------------
SHARDING_SPEC_TOTAL = "dl4j_sharding_spec_total"
SHARDED_PARAM_BYTES_PER_DEVICE = "dl4j_sharded_param_bytes_per_device"

# --- kernel dispatch (ops/pallas_kernels.py) -------------------------------
PALLAS_DISPATCH_TOTAL = "dl4j_pallas_dispatch_total"

# --- recurrent engine (ops/lstm.py) ----------------------------------------
LSTM_DISPATCH_TOTAL = "dl4j_lstm_dispatch_total"
LSTM_PALLAS_BLOCK_STEPS = "dl4j_lstm_pallas_block_steps"

# --- training health (observability/health.py) -----------------------------
HEALTH_GRAD_NORM = "dl4j_health_grad_norm"
HEALTH_UPDATE_NORM = "dl4j_health_update_norm"
HEALTH_NONFINITE_GRADS = "dl4j_health_nonfinite_grads"
HEALTH_LOSS_EMA = "dl4j_health_loss_ema"
HEALTH_CHECKS_TOTAL = "dl4j_health_checks_total"
HEALTH_ALARMS_TOTAL = "dl4j_health_alarms_total"

# --- flight recorder + watchdog (observability/{flight_recorder,watchdog}.py)
FLIGHT_DUMPS_TOTAL = "dl4j_flight_dumps_total"
WATCHDOG_STALLS_TOTAL = "dl4j_watchdog_stalls_total"

# --- trace capture + attribution (observability/profiler.py) ----------------
PROFILE_CAPTURES_TOTAL = "dl4j_profile_captures_total"
PROFILE_CAPTURE_SECONDS = "dl4j_profile_capture_seconds"
PROFILE_CATEGORY_SHARE = "dl4j_profile_category_share"
PROFILE_COLLISIONS_TOTAL = "dl4j_profile_collisions_total"
PROFILE_ACTIVE = "dl4j_profile_active"

# --- model FLOP utilization (observability/compile_tracker.py) --------------
STEP_MFU = "dl4j_step_mfu"

# --- serving engine (keras_server/{registry,batcher,serving,streaming}.py) -
SERVE_REQUESTS_TOTAL = "dl4j_serve_requests_total"
SERVE_REJECTED_TOTAL = "dl4j_serve_rejected_total"
SERVE_ERRORS_TOTAL = "dl4j_serve_errors_total"
SERVE_REQUEST_SECONDS = "dl4j_serve_request_seconds"
SERVE_BATCH_DISPATCH_SECONDS = "dl4j_serve_batch_dispatch_seconds"
SERVE_BATCHES_TOTAL = "dl4j_serve_batches_total"
SERVE_QUEUE_DEPTH = "dl4j_serve_queue_depth"
SERVE_BATCH_OCCUPANCY = "dl4j_serve_batch_occupancy"
SERVE_MODELS_LOADED = "dl4j_serve_models_loaded"
SERVE_HOT_SWAPS_TOTAL = "dl4j_serve_hot_swaps_total"
SERVE_STREAM_SESSIONS = "dl4j_serve_stream_sessions"
SERVE_STREAM_STEPS_TOTAL = "dl4j_serve_stream_steps_total"

# --- sharded multi-replica serving (keras_server/replica.py) ---------------
SERVE_REPLICA_QUEUE_DEPTH = "dl4j_serve_replica_queue_depth"
SERVE_REPLICA_OCCUPANCY = "dl4j_serve_replica_occupancy"
SERVE_REPLICA_ACTIVE_VERSION = "dl4j_serve_replica_active_version"
SERVE_REPLICA_ROUTED_TOTAL = "dl4j_serve_replica_routed_total"

# --- autoscaling serving fleet (keras_server/{autoscaler,replica,admission}
# .py) -----------------------------------------------------------------------
SERVE_FLEET_SIZE = "dl4j_serve_fleet_size"
SERVE_SCALE_EVENTS_TOTAL = "dl4j_serve_scale_events_total"
SERVE_SHED_TOTAL = "dl4j_serve_shed_total"

# --- continuous-batching decode engine (keras_server/{decode,streaming}.py) -
SERVE_SLOT_OCCUPANCY = "dl4j_serve_slot_occupancy"
SERVE_TTFT_SECONDS = "dl4j_serve_ttft_seconds"
SERVE_TOKENS_TOTAL = "dl4j_serve_tokens_total"
SERVE_EVICTIONS_TOTAL = "dl4j_serve_evictions_total"

# --- paged decode memory plane + spec decoding (keras_server/paging.py,
# keras_server/decode.py) ---------------------------------------------------
DECODE_PAGES_IN_USE = "dl4j_decode_page_in_use"
DECODE_PREFIX_SHARE_RATIO = "dl4j_decode_page_prefix_share_ratio"
DECODE_SPEC_ACCEPTANCE = "dl4j_decode_spec_acceptance_ratio"
DECODE_SPEC_TOKENS_TOTAL = "dl4j_decode_spec_tokens_total"
DECODE_STATE_COPY_BYTES_TOTAL = "dl4j_decode_state_copy_bytes_total"

# --- async parameter server (parallel/{param_server,ps_transport}.py) ------
PS_PUSHES_TOTAL = "dl4j_ps_pushes_total"
PS_PULLS_TOTAL = "dl4j_ps_pulls_total"
PS_STALENESS = "dl4j_ps_staleness"
PS_PUSH_WEIGHT = "dl4j_ps_push_weight"
PS_VERSION = "dl4j_ps_version"
PS_WIRE_BYTES_TOTAL = "dl4j_ps_wire_bytes_total"
PS_WORKER_STEPS_TOTAL = "dl4j_ps_worker_steps_total"

# --- elastic training (parallel/elastic.py, cloud.MembershipOracle) --------
ELASTIC_LIVE_WORKERS = "dl4j_elastic_live_workers"
ELASTIC_LEASE_EXPIRIES_TOTAL = "dl4j_elastic_lease_expiries_total"
ELASTIC_FENCED_PUSHES_TOTAL = "dl4j_elastic_fenced_pushes_total"
ELASTIC_HANDOFFS_TOTAL = "dl4j_elastic_handoffs_total"
ELASTIC_JOINS_TOTAL = "dl4j_elastic_joins_total"

# --- streaming routes + broker (streaming/{__init__,broker}.py) ------------
ROUTE_ERRORS_TOTAL = "dl4j_route_errors_total"
BROKER_MESSAGES_TOTAL = "dl4j_broker_messages_total"
BROKER_RECONNECTS_TOTAL = "dl4j_broker_reconnects_total"

# --- zero-copy host data plane (streaming/wire.py, parallel/ps_transport.py,
# --- nativert ingest decode) ------------------------------------------------
WIRE_COPY_BYTES_TOTAL = "dl4j_wire_copy_bytes_total"
SHM_SEGMENTS = "dl4j_shm_segments"
SHM_BYTES_TOTAL = "dl4j_shm_bytes_total"
SHM_REAPED_TOTAL = "dl4j_shm_reaped_total"
INGEST_DECODE_BYTES_TOTAL = "dl4j_ingest_decode_bytes_total"

# --- warm-start compile plane (nn/compile_cache.py, keras_server/decode.py) -
COMPILE_CACHE_HITS_TOTAL = "dl4j_compile_cache_hits_total"
COMPILE_CACHE_MISSES_TOTAL = "dl4j_compile_cache_misses_total"
COMPILE_CACHE_BYTES = "dl4j_compile_cache_bytes"
COMPILE_CACHE_LOAD_SECONDS = "dl4j_compile_cache_load_seconds"
WARMUP_SECONDS = "dl4j_warmup_seconds"
SERVE_BUCKET_GROWTH_STALL_SECONDS = "dl4j_serve_bucket_growth_stall_seconds"

# --- request tracing plane (observability/tracing.py) ----------------------
TRACE_SPANS_TOTAL = "dl4j_trace_spans_total"
TRACE_TRACES_KEPT_TOTAL = "dl4j_trace_traces_kept_total"
TRACE_TRACES_DROPPED_TOTAL = "dl4j_trace_traces_dropped_total"
TRACE_LIVE_TRACES = "dl4j_trace_live_traces"

# --- SLO / error-budget engine (observability/slo.py) ----------------------
SLO_BURN_RATE = "dl4j_slo_burn_rate"
SLO_BUDGET_REMAINING = "dl4j_slo_budget_remaining"
SLO_ALERTING = "dl4j_slo_alerting"
SLO_ALERTS_TOTAL = "dl4j_slo_alerts_total"

# --- metrics registry self-protection (observability/metrics.py) -----------
METRICS_DROPPED_LABELSETS_TOTAL = "dl4j_metrics_dropped_labelsets_total"

# --- fleet observability federation (observability/federation.py) ----------
FED_FRAMES_TOTAL = "dl4j_fed_frames_total"
FED_BYTES_TOTAL = "dl4j_fed_bytes_total"
FED_MEMBERS = "dl4j_fed_members"
FED_TRACE_RECORDS_TOTAL = "dl4j_fed_trace_records_total"
FED_PUBLISH_SECONDS = "dl4j_fed_publish_seconds"
FLEET_DUMPS_TOTAL = "dl4j_fleet_dumps_total"

# --- input pipeline (datasets/prefetch.py) ---------------------------------
PREFETCH_DEPTH = "dl4j_prefetch_depth"
PREFETCH_BYTES_TOTAL = "dl4j_prefetch_bytes_total"
PREFETCH_STAGING_SECONDS_TOTAL = "dl4j_prefetch_staging_seconds_total"
PREFETCH_WAIT_SECONDS_TOTAL = "dl4j_prefetch_wait_seconds_total"
PREFETCH_OVERLAP_RATIO = "dl4j_prefetch_overlap_ratio"

#: every registered name, sorted by constant name; the lint rule parses
#: this module statically, this tuple is for runtime consumers (tests,
#: /metrics docs)
ALL_METRIC_NAMES = tuple(
    v for k, v in sorted(globals().items())
    if not k.startswith("_") and isinstance(v, str) and k.isupper())
