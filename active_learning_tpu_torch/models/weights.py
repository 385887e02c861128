"""The weight carry between the JAX package's flax variables and the
port's modules.

The port's module names are flax's, so a flax path maps to a
``state_dict`` key leaf by leaf:

  params/encoder/<mod>/kernel        -> encoder.<mod>.weight  (HWIO -> OIHW)
  params/encoder/<bn>/{scale,bias}   -> encoder.<bn>.{scale,bias}
  batch_stats/encoder/<bn>/{mean,var}-> encoder.<bn>.{mean,var}
  params/linear/kernel               -> linear.weight         ([in,out] -> [out,in])
  params/linear/bias                 -> linear.bias

with ``<mod>``/``<bn>`` one of ``conv_stem``, ``bn_stem`` or
``stageS_blockB/{Conv_i, BatchNorm_i, downsample_conv, downsample_bn}``
(the same naming ``utils/pretrained.py`` of the JAX package maps torch
checkpoints onto).

The fused optimizer's state ``{"trace": <params-shaped tree>}`` carries
the same way, leaf for leaf onto the parameters' ``state_dict`` keys
(``from_flax_trace`` / ``to_flax_trace``), so a JAX train state and a
port train state can start from identical numbers.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..train.checkpoint import flatten_tree


def _key(path) -> str:
    return ".".join(path)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    # bfloat16 leaves (bf16 optimizer state) are not a numpy dtype:
    # widen to float32, which is exact, and narrow back in torch.
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(arr.astype(np.float32), order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def from_flax_variables(variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree of numpy arrays ->
    ``state_dict`` of float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in flatten_tree(variables.get(collection, {})):
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                elif arr.ndim == 2:
                    arr = arr.T                      # [in, out] -> [out, in]
                else:
                    raise ValueError(f"kernel {'/'.join(path)} of rank "
                                     f"{arr.ndim}")
                path = path[:-1] + ("weight",)
            out[_key(path)] = _to_tensor(arr)
    return out


def to_flax_variables(state_dict: Dict[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """Inverse of ``from_flax_variables``: a ``state_dict`` -> the flax
    variables tree (numpy), e.g. to write with ``train.checkpoint``."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.to(torch.float32)
        arr = value.numpy()
        path = key.split(".")
        if path[-1] == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            path[-1] = "kernel"
        collection = "batch_stats" if path[-1] in ("mean", "var") \
            else "params"
        node = out[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def load_flax_variables(model: torch.nn.Module,
                        variables: Dict[str, Any]) -> None:
    """Copy a flax variables tree into ``model`` in place (strict: every
    key present, every shape equal)."""
    model.load_state_dict(from_flax_variables(variables), strict=True)


def from_flax_trace(opt_state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The fused optimizer's ``{"trace": tree}`` -> momentum buffers keyed
    like the parameters in ``state_dict`` (CPU tensors, the trace's own
    dtype)."""
    return from_flax_variables({"params": opt_state["trace"]})


def to_flax_trace(traces: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``from_flax_trace`` (bf16 buffers come back as float32
    numpy arrays holding the same values)."""
    return {"trace": to_flax_variables(traces)["params"]}
