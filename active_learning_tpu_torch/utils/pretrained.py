"""Pretrained (SSL / transfer) checkpoint ingestion: a torch
``state_dict`` in torchvision's ResNet naming onto the port's model
(the JAX package's ``utils/pretrained.py``).

The reference's surgery (``load_pretrained_weights.py:5-66``): drop keys
holding a ``skip_key`` substring, keep only keys holding a
``required_key`` substring, strip a ``module.`` prefix, rename by the
first matching ``replace_key`` pair; then a partial overlay, so the
modules the checkpoint lacks (the fresh linear head) keep their random
init.  MoCo-v2's ``encoder_q -> encoder`` and skipped ``fc`` come from
its arg pool.

One mapping, straight onto the port's ``state_dict`` keys (its names are
flax's, ``models/weights.py``); torch's OIHW convolutions and
``[out, in]`` linear weights are the port's layouts, so nothing is
transposed:

  torch key                         port key
  ------------------------------------------------------------------
  encoder.conv1.weight              encoder.conv_stem.weight
  encoder.bn1.{weight,bias}         encoder.bn_stem.{scale,bias}
  encoder.bn1.running_{mean,var}    encoder.bn_stem.{mean,var}
  encoder.layerL.B.convN.weight     encoder.stageL_blockB.Conv_{N-1}.weight
  encoder.layerL.B.bnN.*            encoder.stageL_blockB.BatchNorm_{N-1}.*
  encoder.layerL.B.downsample.0/1   ... .downsample_conv / .downsample_bn
  linear.{weight,bias}              linear.{weight,bias}

``num_batches_tracked`` (one a BatchNorm: 53 in a ResNet-50) and the
encoder's own ``fc`` have no counterpart and are dropped; any other key
that does not map is an error, since ignoring it is how a wrong
checkpoint goes unnoticed.  A 7x7 stem kernel loaded into an s2d-stem
model is folded exactly (``models/resnet.s2d_stem_kernel``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import PretrainedConfig
from ..models.resnet import s2d_stem_kernel
from .logging import get_logger


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint as ``{key: CPU tensor}``, unwrapping the common
    ``{"state_dict": ...}`` wrapper (MoCo et al.).  The file is a
    pickle: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach() if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)) for k, v in ckpt.items()}


def surgery(state: Mapping[str, torch.Tensor],
            required_key: Optional[Iterable[str]] = None,
            skip_key: Optional[Iterable[str]] = None,
            replace_map: Optional[Mapping[str, str]] = None
            ) -> Dict[str, torch.Tensor]:
    """The reference's key filtering and renaming: drop keys holding any
    ``skip_key`` substring, then keys holding no ``required_key``
    substring; strip a ``module.`` prefix; apply the first matching
    ``replace_map`` rename."""
    replace_map = dict(replace_map or {})
    required = tuple(required_key or ())
    skip = tuple(skip_key or ())

    def keep(k: str) -> bool:
        if any(s in k for s in skip):
            return False
        return not required or any(s in k for s in required)

    def rename(k: str) -> str:
        for old, new in replace_map.items():
            if old in k:
                return k.replace(old, new)
        return k

    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if not keep(k):
            continue
        if k.startswith("module."):
            k = k[len("module."):]
        out[rename(k)] = v
    return out


_BN_LEAF = {"weight": "scale", "bias": "bias", "running_mean": "mean",
            "running_var": "var"}


def _bn_leaf(key: str, leaf: str) -> str:
    try:
        return _BN_LEAF[leaf]
    except KeyError:
        raise KeyError(f"No port mapping for torch key '{key}'") from None


def torch_key_to_port(key: str) -> Optional[str]:
    """The port's ``state_dict`` key of one torchvision-ResNet key; None
    for keys with no counterpart (``num_batches_tracked``, the encoder's
    ``fc``); KeyError for an unrecognized key."""
    if key.endswith("num_batches_tracked"):
        return None
    parts = key.split(".")
    rest = parts[1:]
    if parts[0] == "encoder" and len(rest) >= 2:
        if rest[0] == "conv1" and rest[1] == "weight":
            return "encoder.conv_stem.weight"
        if rest[0] == "bn1":
            return f"encoder.bn_stem.{_bn_leaf(key, rest[1])}"
        m = re.fullmatch(r"layer(\d+)", rest[0])
        if m and len(rest) >= 4:
            mod = f"encoder.stage{int(m.group(1))}_block{int(rest[1])}"
            sub, leaf = rest[2], rest[3]
            cm = re.fullmatch(r"conv(\d+)", sub)
            if cm and leaf == "weight":
                return f"{mod}.Conv_{int(cm.group(1)) - 1}.weight"
            bm = re.fullmatch(r"bn(\d+)", sub)
            if bm:
                return (f"{mod}.BatchNorm_{int(bm.group(1)) - 1}."
                        f"{_bn_leaf(key, leaf)}")
            if sub == "downsample" and len(rest) >= 5:
                if rest[3] == "0" and rest[4] == "weight":
                    return f"{mod}.downsample_conv.weight"
                if rest[3] == "1":
                    return f"{mod}.downsample_bn.{_bn_leaf(key, rest[4])}"
        if rest[0] == "fc":
            # The encoder's own fc, an Identity in the reference
            # (resnet_simclr.py:21): nothing to load into.
            return None
    if parts[0] == "linear" and len(parts) == 2 and parts[1] in (
            "weight", "bias"):
        return key
    raise KeyError(f"No port mapping for torch key '{key}'")


def _fold_stem(value: torch.Tensor) -> torch.Tensor:
    """``[F, C, 7, 7]`` (OIHW) -> the s2d stem's ``[F, 4C, 4, 4]``."""
    hwio = s2d_stem_kernel(value.permute(2, 3, 1, 0))
    return hwio.permute(3, 2, 0, 1)


@torch.no_grad()
def overlay_torch_state(model: torch.nn.Module,
                        torch_state: Mapping[str, torch.Tensor],
                        strict: bool = True) -> int:
    """Copy every mappable checkpoint tensor into ``model`` in place (the
    reference's ``init_dict.update(net_dict)``); returns the tensors
    copied.  A shape mismatch always raises; an unknown key raises when
    ``strict``."""
    targets: Dict[str, torch.Tensor] = dict(model.named_parameters())
    targets.update(model.named_buffers())
    loaded = 0
    for key, value in torch_state.items():
        try:
            port_key = torch_key_to_port(key)
        except KeyError:
            if strict:
                raise
            continue
        if port_key is None:
            continue
        if port_key not in targets:
            raise KeyError(
                f"Checkpoint key '{key}' maps to {port_key}, absent from "
                "the model (wrong depth or variant?)")
        target = targets[port_key]
        value = torch.as_tensor(value)
        if (port_key == "encoder.conv_stem.weight" and value.ndim == 4
                and tuple(value.shape[2:]) == (7, 7)
                and tuple(target.shape[2:]) == (4, 4)):
            # A 7x7-stem checkpoint into an s2d-stem model: the folded
            # kernel computes the same convolution.
            value = _fold_stem(value)
        if tuple(target.shape) != tuple(value.shape):
            raise ValueError(
                f"Shape mismatch for '{key}' -> {port_key}: ckpt "
                f"{tuple(value.shape)} vs model {tuple(target.shape)}")
        # copy_ bumps the version counter the models' caches key on.
        target.copy_(value.to(target.dtype))
        loaded += 1
    get_logger().info(f"Overlaid {loaded} pretrained tensors")
    return loaded


def apply_pretrained(model: torch.nn.Module, cfg: PretrainedConfig) -> int:
    """Load, surgery, overlay: the configured checkpoint onto ``model``
    in place, after its random init; returns the tensors copied."""
    state = surgery(load_torch_state_dict(cfg.path),
                    required_key=cfg.required_key, skip_key=cfg.skip_key,
                    replace_map=cfg.replace_map)
    return overlay_torch_state(model, state)
