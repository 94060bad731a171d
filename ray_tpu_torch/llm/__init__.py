"""ray_tpu_torch.llm — continuous-batching LLM inference on a paged KV cache.

  * cache.py — refcounted, content-addressed block allocator over the
    preallocated paged KV pools (automatic prefix caching)
  * model_runner.py — prefill / partial-prefill / decode / verify /
    block-copy step programs for the GPT model, over in-place device pools,
    and the async decode dispatch
  * scheduler.py — iteration-level prefix-aware admission, continuation,
    preemption
  * engine.py — LLMEngine core + LLMServer (background loop; in process,
    or the engine actor behind Serve)
  * observability.py — per-request lifecycle spans, latency-histogram
    boundaries, and the engine flight recorder
  * spec/ — speculative decoding proposers (n-gram prompt lookup, draft
    model) feeding the engine's k-token verify-with-rollback phase
  * serve.py — ingress deployment behind Serve's HTTP proxy and replicas,
    forwarding to one named engine actor (`llm_engine:<name>`)
  * kvfabric/ — fleet-wide KV fabric: host-memory spill tier shared across
    engines, disaggregated prefill/decode roles, prefix-affinity routing
"""

from ray_tpu_torch.llm.cache import (
    EVICTION_POLICIES,
    NULL_BLOCK,
    BlockAllocator,
    CacheOutOfBlocks,
    blocks_for_tokens,
    hash_block_tokens,
    prefix_block_hashes,
)
from ray_tpu_torch.llm.config import EngineConfig, KVFabricConfig
from ray_tpu_torch.llm.engine import LLMEngine, LLMServer
from ray_tpu_torch.llm.model_runner import GPTRunner
from ray_tpu_torch.llm.scheduler import (
    FINISH_ABORTED,
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    Request,
    Scheduler,
    Sequence,
)
from ray_tpu_torch.llm.spec import NgramProposer, Proposer, build_proposer

__all__ = [
    "BlockAllocator",
    "CacheOutOfBlocks",
    "EVICTION_POLICIES",
    "EngineConfig",
    "FINISH_ABORTED",
    "FINISH_EOS",
    "FINISH_ERROR",
    "FINISH_LENGTH",
    "GPTRunner",
    "KVFabricConfig",
    "LLMEngine",
    "LLMServer",
    "NULL_BLOCK",
    "NgramProposer",
    "Proposer",
    "Request",
    "Scheduler",
    "Sequence",
    "blocks_for_tokens",
    "build_proposer",
    "hash_block_tokens",
    "prefix_block_hashes",
]
