"""Profiling entry points of the attention kernels, the port's counterparts
of the reference's ``benchmarks/profile_attn_*.py`` scripts:

    python -m ray_tpu_torch.profiling.attn_dissect   # K8
    python -m ray_tpu_torch.profiling.attn_variants  # K9, K4 + K5, K2 + K3
    python -m ray_tpu_torch.profiling.attn_subtile   # K10

Each runs on the card by default (``--device cuda``) at the scripts' shape
B24 S1024 H12 D64 bf16; ``--device cpu`` runs the plain versions once at a
small shape and reports no device time. Nothing runs at import.
"""
