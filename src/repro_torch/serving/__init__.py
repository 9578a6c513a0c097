"""Serving runtime of the port: continuous batching over a slot KV cache,
dense or INT8, with per-request sampling, deadlines, cancel, load shedding
and the seeded fault harness (``repro/serving`` minus the paged layout).

``kv_cache``, ``sampling``, ``scheduler`` and ``faults`` are model-free and
import eagerly (``models/layers.py`` uses ``kv_cache``); the ``Engine``
imports the model stack, so it loads lazily, which keeps
``repro_torch.serving.kv_cache`` importable from inside
``repro_torch.models`` without a cycle.
"""
from repro_torch.serving.faults import (ALLOC_FAIL, KINDS, NAN_LOGITS,
                                        SPILL_FAIL, FaultPlan, InjectedFault)
from repro_torch.serving.kv_cache import (KVCacheConfig, QuantizedKV,
                                          cache_bytes, cache_is_finite,
                                          init_slot_cache, kv_dequantize,
                                          kv_quantize, kv_update,
                                          set_slot_rows, slot_rows,
                                          write_slot)
from repro_torch.serving.sampling import SamplingParams, sample_tokens
from repro_torch.serving.scheduler import (AdmittedBatch,
                                           DuplicateRequestError, EngineError,
                                           EngineInvariantError,
                                           EngineStalledError,
                                           GenerationRequest,
                                           GenerationResult,
                                           InvalidRequestError,
                                           QueueFullError, RequestStatus,
                                           ResumeTicket, Scheduler)

_LAZY = ("Engine", "EngineConfig", "batch_buckets")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.serving import engine
        return getattr(engine, name)
    raise AttributeError(name)


__all__ = ["ALLOC_FAIL", "AdmittedBatch", "DuplicateRequestError", "Engine",
           "EngineConfig", "EngineError", "EngineInvariantError",
           "EngineStalledError", "FaultPlan", "GenerationRequest",
           "GenerationResult", "InjectedFault", "InvalidRequestError",
           "KINDS", "KVCacheConfig", "NAN_LOGITS", "QuantizedKV",
           "QueueFullError", "RequestStatus", "ResumeTicket", "SPILL_FAIL",
           "SamplingParams", "Scheduler", "batch_buckets", "cache_bytes",
           "cache_is_finite", "init_slot_cache", "kv_dequantize",
           "kv_quantize", "kv_update", "sample_tokens", "set_slot_rows",
           "slot_rows", "write_slot"]
