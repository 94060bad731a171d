"""Fleet-wide KV fabric: KV blocks as first-class fleet objects.

Three composing pieces over the content-addressed paged cache:

  * **Spill tier** (`store.KVFabricStore` / `KVFabricClient`): eviction
    and drain demote keyed blocks to a shared host-DRAM store keyed by
    chain hash instead of destroying them; admission extends the prefix
    match past the device cache into the fabric and restores hits into
    freshly allocated slots.
  * **Disaggregated prefill/decode** (`disagg.DisaggregatedLLM` +
    `EngineConfig.engine_role`): a prefill-role engine publishes each
    finished block and hands off; a decode-role engine admits the
    handoff as a pure fabric hit.
  * **Prefix-affinity routing** (`affinity`): the serve router's replica
    pick consults a rendezvous hash on the prompt's leading block-chain
    hash, as a tie-break layered on p2c.

Everything is gated on `EngineConfig.kv_fabric` (default off): with the
knob unset, no fabric actor exists and every existing path is untouched.
"""

from ray_tpu_torch.llm.config import KVFabricConfig
from ray_tpu_torch.llm.kvfabric.affinity import (
    LLMPrefixAffinity,
    leading_block_hash,
    rendezvous_pick,
)
from ray_tpu_torch.llm.kvfabric.disagg import DisaggregatedLLM
from ray_tpu_torch.llm.kvfabric.store import (
    KVFabricClient,
    KVFabricStore,
    get_or_create_fabric_actor,
    payload_nbytes,
)

__all__ = [
    "KVFabricConfig",
    "KVFabricClient",
    "KVFabricStore",
    "DisaggregatedLLM",
    "LLMPrefixAffinity",
    "get_or_create_fabric_actor",
    "leading_block_hash",
    "payload_nbytes",
    "rendezvous_pick",
]
