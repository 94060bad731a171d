"""Convert the reference package's flax GPT params into the port's
``state_dict``.

The input is the flax param tree as nested dicts of numpy arrays (unbox
``LogicallyPartitioned`` leaves with ``flax.linen.meta.unbox`` and map
``np.asarray`` over the tree on the JAX side; this module imports neither).
Dense ``kernel [in, out]`` becomes ``weight [out, in]``; LayerNorm
``scale``/``bias`` become ``weight``/``bias``; the embeddings' ``embedding``
becomes ``weight``; the LM head stays tied to ``wte``. An MoE block's
``moe_mlp/{router, w_in, w_out}`` keep their names, layouts and dtypes
(bf16 experts stay bf16). ``resnet_params_from_flax`` converts the flax
ResNet's ``params`` and ``batch_stats``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = ("attn_qkv", "attn_proj", "mlp_in", "mlp_out")
_NORMS = ("ln_1", "ln_2")


def _tensor(x: Any, transpose: bool = False, dtype=np.float32) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of `dtype` (None: its own; numpy's
    bfloat16 from ml_dtypes, which torch cannot read, crosses as its bits)."""
    arr = np.asarray(x) if dtype is None else np.asarray(x, dtype=dtype)
    arr = np.array(arr.T if transpose else arr, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
        for name in _NORMS:
            out[f"h.{i}.{name}.weight"] = _tensor(block[name]["scale"])
            out[f"h.{i}.{name}.bias"] = _tensor(block[name]["bias"])
        if "moe_mlp" in block:
            # Expert weights keep their own dtype (the model's) and layout.
            for name, leaf in block["moe_mlp"].items():
                out[f"h.{i}.moe_mlp.{name}"] = _tensor(leaf, dtype=None)
        for name in (n for n in _DENSE if n in block):
            out[f"h.{i}.{name}.weight"] = _tensor(
                block[name]["kernel"], transpose=True
            )
            out[f"h.{i}.{name}.bias"] = _tensor(block[name]["bias"])
    return out


def _norm_leaves(prefix: str, params: Mapping[str, Any], stats: Mapping[str, Any],
                 name: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _tensor(params[name]["scale"])
    out[f"{prefix}.bias"] = _tensor(params[name]["bias"])
    if name in stats:
        out[f"{prefix}.mean"] = _tensor(stats[name]["mean"])
        out[f"{prefix}.var"] = _tensor(stats[name]["var"])


def _conv_leaf(kernel: Any) -> torch.Tensor:
    """HWIO [kh, kw, in, out] → OIHW."""
    return _tensor(np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1)))


def resnet_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ResNet variables (``{"params": ..., "batch_stats": ...}``, the
    stats only with ``norm="batch"``, or the bare params) → a
    ``ResNet.load_state_dict``-ready dict of f32 CPU tensors. Conv kernels
    go from HWIO to OIHW, the ``head`` kernel is transposed, norm
    ``scale``/``bias`` become ``weight``/``bias`` and the batch statistics
    ``mean``/``var`` buffers. Flax names its blocks ``ResNetBlock_{n}`` or
    ``BottleneckBlock_{n}``, numbered across stages; inside one,
    ``Conv_{j}`` and ``GroupNorm_{j}`` / ``BatchNorm_{j}`` are the port's
    ``conv_{j}`` / ``norm_{j}``."""
    params = tree.get("params", tree)
    stats = tree.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {"conv_init.weight": _conv_leaf(params["conv_init"]["kernel"])}
    _norm_leaves("norm_init", params, stats, "norm_init", out)
    blocks = sorted(
        (k for k in params if k.startswith(("ResNetBlock_", "BottleneckBlock_"))),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    for n, key in enumerate(blocks):
        if int(key.rsplit("_", 1)[1]) != n:
            raise ValueError(f"non-contiguous block indices: {blocks}")
        block, block_stats = params[key], stats.get(key, {})
        for name in block:
            if name.startswith("Conv_") or name == "conv_proj":
                port = name.lower()
                out[f"blocks.{n}.{port}.weight"] = _conv_leaf(block[name]["kernel"])
            else:  # GroupNorm_{j} / BatchNorm_{j} / norm_proj
                port = "norm_" + name.rpartition("_")[2]
                _norm_leaves(f"blocks.{n}.{port}", block, block_stats, name, out)
    out["head.weight"] = _tensor(params["head"]["kernel"], transpose=True)
    out["head.bias"] = _tensor(params["head"]["bias"])
    return out
