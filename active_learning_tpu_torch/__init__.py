"""PyTorch + CUDA port of ``active_learning_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; every module here
mirrors its counterpart's name so a reader can find it.  This package
imports torch, numpy and the standard library only — nothing of jax,
flax, optax, msgpack or ``active_learning_tpu`` — and keeps its own copy
of whatever host-pure code it needs.

Slice 1 is the scoring service (``python -m active_learning_tpu_torch
serve``): SSLResNet18/50 in eval mode, the softmax-statistics pass, and
the HTTP front end, with two hand-written Hopper kernels on the path
(``ops/prob_stats.py`` and ``ops/bn_act.py``, both CUDA C++).
"""
