"""Convert the reference package's flax GPT params into the port's
``state_dict``.

The input is the flax param tree as nested dicts of numpy arrays (unbox
``LogicallyPartitioned`` leaves with ``flax.linen.meta.unbox`` and map
``np.asarray`` over the tree on the JAX side; this module imports neither).
Dense ``kernel [in, out]`` becomes ``weight [out, in]``; LayerNorm
``scale``/``bias`` become ``weight``/``bias``; the embeddings' ``embedding``
becomes ``weight``; the LM head stays tied to ``wte``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = ("attn_qkv", "attn_proj", "mlp_in", "mlp_out")
_NORMS = ("ln_1", "ln_2")


def _tensor(x: Any, transpose: bool = False) -> torch.Tensor:
    arr = np.asarray(x, dtype=np.float32)
    return torch.from_numpy(np.array(arr.T if transpose else arr, copy=True))


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax GPT params (``{"params": {...}}`` or the inner dict) → a
    ``GPT.load_state_dict``-ready dict of f32 CPU tensors."""
    params = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {
        "wte.weight": _tensor(params["wte"]["embedding"]),
        "wpe.weight": _tensor(params["wpe"]["embedding"]),
        "ln_f.weight": _tensor(params["ln_f"]["scale"]),
        "ln_f.bias": _tensor(params["ln_f"]["bias"]),
    }
    layers = sorted(
        (int(k[2:]) for k in params if k.startswith("h_")),
    )
    if layers != list(range(len(layers))):
        raise ValueError(f"non-contiguous block indices {layers}")
    for i in layers:
        block = params[f"h_{i}"]
        if "moe_mlp" in block:
            raise NotImplementedError(
                "MoE blocks are not ported yet (ROADMAP §B: the ResNet/MoE slice)"
            )
        for name in _NORMS:
            out[f"h.{i}.{name}.weight"] = _tensor(block[name]["scale"])
            out[f"h.{i}.{name}.bias"] = _tensor(block[name]["bias"])
        for name in _DENSE:
            out[f"h.{i}.{name}.weight"] = _tensor(
                block[name]["kernel"], transpose=True
            )
            out[f"h.{i}.{name}.bias"] = _tensor(block[name]["bias"])
    return out
