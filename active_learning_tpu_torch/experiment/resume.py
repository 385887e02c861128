"""Round-level experiment save (the JAX package's
``experiment/resume.py::save_experiment``): ``experiment_state.npz``
(pool arrays + init key), ``aux_state.msgpack`` (the sampler's own
state, ``Strategy.aux_state_bytes``: VAAL's VAE, discriminator and
their optimizers) and ``experiment_state.json`` (round, rng state,
config echo, metrics key, best epoch) under
``{ckpt_path}/{exp_name}_{exp_hash}``, each an atomic tmp + rename,
meta last; a stale aux file is removed when the sampler has none.  The
port writes the JAX package's keys and layouts, so the npz of a port
run and of a JAX run with the same flags compare key by key.  Loading a
saved experiment, aux state included (``--resume_training``), is still
to be ported (ROADMAP.md)."""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from ..config import ExperimentConfig, config_to_dict
from ..utils.logging import get_logger

STATE_FILE = "experiment_state.npz"
META_FILE = "experiment_state.json"
AUX_FILE = "aux_state.msgpack"
# The JAX package's weight-compatibility version (train/checkpoint.py
# there): the port's checkpoints use the same layout.
MODEL_FORMAT_VERSION = 2


def state_dir(cfg: ExperimentConfig) -> str:
    return os.path.join(cfg.ckpt_path,
                        f"{cfg.exp_name}_{cfg.exp_hash or 'no_hash'}")


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(e) for e in v]
    return str(v)


def save_experiment(strategy, cfg: ExperimentConfig) -> str:
    """Persist the end-of-round state; called once per round after
    ``test()``."""
    directory = state_dir(cfg)
    os.makedirs(directory, exist_ok=True)
    arrays = strategy.pool.to_arrays()
    arrays["init_key"] = strategy.init_key
    state_path = os.path.join(directory, STATE_FILE)
    np.savez(state_path + ".tmp.npz", **arrays)
    os.replace(state_path + ".tmp.npz", state_path)
    aux_path = os.path.join(directory, AUX_FILE)
    aux = strategy.aux_state_bytes()
    if aux is not None:
        with open(aux_path + ".tmp", "wb") as fh:
            fh.write(aux)
        os.replace(aux_path + ".tmp", aux_path)
    elif os.path.exists(aux_path):
        os.remove(aux_path)
    meta = {
        "round": int(strategy.round),
        "model_format": MODEL_FORMAT_VERSION,
        "rng_state": strategy.rng.bit_generator.state,
        "config": {k: _jsonable(v) for k, v in config_to_dict(cfg).items()},
        "experiment_key": getattr(strategy.sink, "experiment_key", None),
        "best_epoch": int(strategy.best_epoch),
    }
    meta_path = os.path.join(directory, META_FILE)
    with open(meta_path + ".tmp", "w") as fh:
        json.dump(meta, fh, indent=2)
    os.replace(meta_path + ".tmp", meta_path)
    get_logger().info(f"Saved experiment state for round {strategy.round} "
                      f"to {directory}")
    return directory
