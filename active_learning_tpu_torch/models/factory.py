"""Model factory: dataset/model name -> SSLClassifier on a device (the
JAX package's ``models/factory.py``).  The CIFAR stem follows the class
count (``num_classes == 10``), as the reference does."""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..registry import MODELS
from .resnet import SSLClassifier, resnet18, resnet50

MODELS.register("SSLResNet18", resnet18)
MODELS.register("SSLResNet50", resnet50)

_DTYPE_NAMES = {
    "float32": torch.float32, "f32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}

# Dataset -> class count.
DATASET_NUM_CLASSES = {
    "cifar10": 10,
    "imbalanced_cifar10": 10,
    "imagenet": 1000,
    "imbalanced_imagenet": 1000,
    "synthetic": 10,
}


def resolve_dtype(spec: Any, device: Union[str, torch.device]
                  ) -> torch.dtype:
    """A config dtype spec (name, torch dtype, or "auto") -> the compute
    dtype.  "auto" is bf16 on the card and float32 on the CPU, as the
    JAX package picks bf16 on the TPU.  Parameters and BN statistics
    stay float32 either way."""
    if spec is None or spec == "auto":
        return (torch.bfloat16 if torch.device(device).type == "cuda"
                else torch.float32)
    if isinstance(spec, str):
        try:
            return _DTYPE_NAMES[spec.lower()]
        except KeyError:
            raise ValueError(
                f"Unknown dtype {spec!r}; expected one of "
                f"{sorted(_DTYPE_NAMES)} or 'auto'") from None
    return spec


def resolve_bn_stats_dtype(spec: Any, compute_dtype: torch.dtype,
                           device: Union[str, torch.device]
                           ) -> Optional[torch.dtype]:
    """BN-statistics precision, which selects the eval formula: bf16
    -> ``FusedBatchNorm``'s ``x·mul − sub`` in the compute dtype, None
    -> flax ``nn.BatchNorm``'s float32 formula.  "auto" follows the
    compute dtype."""
    if spec is None or spec == "auto":
        return torch.bfloat16 if compute_dtype == torch.bfloat16 else None
    resolved = resolve_dtype(spec, device)
    return torch.bfloat16 if resolved == torch.bfloat16 else None


def get_network(dataset: str, model_name: str,
                num_classes: Optional[int] = None, dtype: Any = "auto",
                stem: str = "default", bn_stats_dtype: Any = "auto",
                device: Union[str, torch.device] = "cuda",
                num_filters: int = 64,
                freeze_feature: bool = False) -> SSLClassifier:
    """The network on ``device``, channels-last, in eval mode (the
    trainer switches it to training mode for a fit)."""
    if num_classes is None:
        try:
            num_classes = DATASET_NUM_CLASSES[dataset]
        except KeyError:
            raise KeyError(f"Unknown dataset '{dataset}'; pass num_classes "
                           "explicitly") from None
    factory = MODELS.get(model_name)
    cifar_stem = num_classes == 10
    if stem in (None, "auto") or cifar_stem:
        # CIFAR datasets keep their SimCLR stem whatever the global stem
        # choice, as in the JAX package.
        stem = "default"
    if stem != "default":
        raise NotImplementedError(
            f"stem {stem!r} is not ported yet (ROADMAP.md); the port "
            "runs the default 7x7/s2 stem and the CIFAR stem")
    compute = resolve_dtype(dtype, device)
    fused = resolve_bn_stats_dtype(bn_stats_dtype, compute,
                                   device) == torch.bfloat16
    model = factory(num_classes=num_classes, cifar_stem=cifar_stem,
                    dtype=compute, fused_stats=fused,
                    num_filters=num_filters, freeze_feature=freeze_feature)
    return model.to(device=device, memory_format=torch.channels_last)
