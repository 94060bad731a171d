"""ray_tpu_torch.llm.spec — speculative decoding proposers.

Decode emits one token per target-model step; speculation turns that into
"guess k tokens cheaply, score them all in ONE target step, keep the
longest agreeing prefix plus the correction/bonus token". The guessing is
pluggable (Proposer): NgramProposer matches the sequence's own token
history (prompt lookup — free, shines on repetitive text), and
DraftModelProposer runs a smaller GPT through the same runner harness
(costs draft compute, generalizes to novel text). Verification
(GPTRunner.verify + the engine's rollback) guarantees greedy outputs are
token-identical with speculation on or off; proposers only change speed.

Select via EngineConfig(speculation="ngram"|"draft", ...); see
llm/config.py for the knobs and llm/engine.py for the verify phase.
"""

from ray_tpu_torch.llm.spec.proposer import NgramProposer, Proposer


def build_proposer(engine_config, seed: int = 0, draft_params=None, device=None,
                   tp_group=None):
    """The proposer EngineConfig.speculation selects (None when "off").
    `draft_params` optionally supplies trained draft weights (a state dict
    of the draft GPT); without them the draft model initializes from
    `seed` like the target. The draft runs on `device` (the engine's) and,
    under tensor parallelism, on the engine's ranks (`tp_group`)."""
    if engine_config.speculation == "off":
        return None
    if engine_config.speculation == "ngram":
        return NgramProposer(
            ngram_max=engine_config.ngram_max,
            ngram_min=engine_config.ngram_min,
        )
    # "draft" (validated by EngineConfig.__post_init__). Deferred import:
    # the draft path is the only one that needs the model stack.
    from ray_tpu_torch.llm.spec.draft import DraftModelProposer

    return DraftModelProposer(
        engine_config.draft_model_config,
        engine_config,
        params=draft_params,
        seed=seed,
        device=device,
        tp_group=tp_group,
    )


__all__ = [
    "NgramProposer",
    "Proposer",
    "build_proposer",
]
