from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.costmodel import CostModel, DispatchCost
from repro_torch.serve.engine import (ContinuousBatchingEngine, DecodeEngine,
                                      sample_step)
from repro_torch.serve.kv_cache import SlotKVCache
from repro_torch.serve.metrics import MetricsRegistry, format_report
from repro_torch.serve.prefix_cache import BlockPool, RadixPrefixCache
from repro_torch.serve.quantized import pack_tree
from repro_torch.serve.scheduler import RequestScheduler
from repro_torch.serve.trace import (RequestTracer, TraceWriter,
                                     export_chrome_trace, read_jsonl)

__all__ = ["BlockPool", "ContinuousBatchingEngine", "CostModel",
           "DecodeEngine", "DispatchCost", "EngineConfig",
           "MetricsRegistry", "RadixPrefixCache", "RequestScheduler",
           "RequestTracer", "SamplingParams", "SlotKVCache", "TraceWriter",
           "export_chrome_trace", "format_report", "pack_tree",
           "read_jsonl", "sample_step"]
