from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.engine import (ContinuousBatchingEngine, DecodeEngine,
                                      sample_step)
from repro_torch.serve.kv_cache import SlotKVCache
from repro_torch.serve.prefix_cache import BlockPool, RadixPrefixCache
from repro_torch.serve.quantized import pack_tree
from repro_torch.serve.scheduler import RequestScheduler

__all__ = ["BlockPool", "ContinuousBatchingEngine", "DecodeEngine",
           "EngineConfig", "RadixPrefixCache", "RequestScheduler",
           "SamplingParams", "SlotKVCache", "pack_tree", "sample_step"]
