"""Disaggregated prefill/decode over the KV fabric.

Two engine actors with one fabric between them: the prefill-role engine
(`EngineConfig.engine_role="prefill"`) runs chunked prefill only —
publishing every finished KV block to the fabric as its chunk completes
and finishing the request at its first token — and the decode-role
engine admits the handed-off request as a pure fabric hit, restoring the
published blocks into its own pool and generating the rest. The handoff
is actors + object refs end to end: the prefill reply ref gates the
decode submission, and the KV bytes move through the fabric store, not
through any new step program.

Greedy outputs are token-identical to a unified engine: the decode
engine's admission restores every full prefix block (cache-hit tokens),
suffix-prefills the trailing partial block, and its first generated
token reproduces the prefill engine's — the same contract as a local
prefix-cache hit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.llm.config import EngineConfig
from ray_tpu_torch.llm.engine import LLMServer


class DisaggregatedLLM:
    """A prefill-role + decode-role engine pair sharing one fabric.

    `engine_config` must name a kv_fabric; its engine_role is overridden
    per member ("prefill" additionally forces chunked prefill on when the
    caller left it off, since the prefill role requires it). Both engines
    run on `device`, which defaults to CUDA and raises without it; pass
    "cpu" to run them there."""

    def __init__(
        self,
        model_config=None,
        engine_config: Optional[EngineConfig] = None,
        params=None,
        seed: int = 0,
        name: str = "disagg",
        max_concurrency: int = 8,
        device=None,
    ):
        # Resolved here, before any actor exists: a string crosses the
        # actor boundary, and a missing card raises in the caller.
        device = str(resolve_device(device))
        engine_config = engine_config or EngineConfig()
        if engine_config.kv_fabric is None:
            raise ValueError(
                "DisaggregatedLLM requires engine_config.kv_fabric — the "
                "fabric is the only channel prefilled KV blocks travel "
                "from the prefill engine to the decode engine"
            )
        prefill_cfg = dataclasses.replace(
            engine_config,
            engine_role="prefill",
            max_prefill_tokens_per_step=(
                engine_config.max_prefill_tokens_per_step
                if engine_config.prefill_token_budget is not None
                else -1
            ),
        )
        decode_cfg = dataclasses.replace(engine_config, engine_role="decode")

        def _engine(suffix: str, cfg: EngineConfig):
            return (
                ray_tpu_torch.remote(LLMServer)
                .options(
                    name=f"llm_engine:{name}-{suffix}",
                    get_if_exists=True,
                    max_concurrency=max_concurrency,
                )
                .remote(model_config, cfg, params, seed, device=device)
            )

        self._prefill = _engine("prefill", prefill_cfg)
        self._decode = _engine("decode", decode_cfg)

    def generate(
        self,
        prompt_ids: List[int],
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
    ) -> List[int]:
        """Prefill on one engine, decode on the other; returns the decode
        engine's generated token ids (the full generation — the prefill
        engine's single first token is subsumed by it)."""
        # The handoff: the prefill reply ref is the barrier — its KV
        # blocks are published to the fabric before the reply seals, so
        # the decode admission that follows sees them as fabric hits.
        ray_tpu_torch.get(self._prefill.generate.remote(prompt_ids, 1, eos_id))
        return ray_tpu_torch.get(
            self._decode.generate.remote(prompt_ids, max_new_tokens, eos_id)
        )

    def prefill_stats(self) -> dict:
        return ray_tpu_torch.get(self._prefill.metrics.remote())

    def decode_stats(self) -> dict:
        return ray_tpu_torch.get(self._decode.metrics.remote())

    def shutdown(self) -> None:
        for handle in (self._prefill, self._decode):
            try:
                ray_tpu_torch.get(handle.shutdown.remote(), timeout=10.0)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass
