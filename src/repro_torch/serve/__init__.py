"""The port's serving layer (`repro.serve`): the continuous-batching
runtime over its two families (paged KV for decoders, slot-pooled state
for Mamba2), the fixed-batch engines (every family, with the VLM's and the
encoder-decoder's modality extras), sampling, the paged KV cache and the
state cache, the plan router and the trace with its audit."""

from repro_torch.serve.engine import FixedBatchEngine, Request, ServeConfig, ServeEngine
from repro_torch.serve.family import (
    DecoderFamilyAdapter,
    SSMFamilyAdapter,
    resolve_family_adapter,
)
from repro_torch.serve.kvcache import BlockAllocator, KVCacheConfig, PagedKVCache
from repro_torch.serve.metrics import ServeMetrics, percentile
from repro_torch.serve.router import (
    DEFAULT_CHUNK_TOKENS,
    FAMILY_STAGES,
    PlanRouter,
    build_serve_graph,
    build_serve_plan,
    serve_stages,
)
from repro_torch.serve.runtime import ContinuousEngine, RuntimeConfig
from repro_torch.serve.sampling import GREEDY, SamplingParams, truncate_at_eos
from repro_torch.serve.scheduler import ContinuousScheduler, PagedCapacity, ServeRequest
from repro_torch.serve.statecache import (
    SlotAllocator,
    SlotCapacity,
    SlotStateCache,
    StateCacheConfig,
)
from repro_torch.serve.trace import (
    NULL_RECORDER,
    TraceRecorder,
    load_trace,
    write_trace,
)

__all__ = [
    "BlockAllocator",
    "ContinuousEngine",
    "DEFAULT_CHUNK_TOKENS",
    "ContinuousScheduler",
    "DecoderFamilyAdapter",
    "FAMILY_STAGES",
    "FixedBatchEngine",
    "GREEDY",
    "KVCacheConfig",
    "NULL_RECORDER",
    "PagedCapacity",
    "PagedKVCache",
    "PlanRouter",
    "Request",
    "RuntimeConfig",
    "SSMFamilyAdapter",
    "SamplingParams",
    "ServeConfig",
    "ServeEngine",
    "ServeMetrics",
    "ServeRequest",
    "SlotAllocator",
    "SlotCapacity",
    "SlotStateCache",
    "StateCacheConfig",
    "TraceRecorder",
    "build_serve_graph",
    "build_serve_plan",
    "load_trace",
    "percentile",
    "resolve_family_adapter",
    "serve_stages",
    "truncate_at_eos",
    "write_trace",
]
