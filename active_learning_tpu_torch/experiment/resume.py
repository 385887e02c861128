"""Round-level experiment save and restore (the JAX package's
``experiment/resume.py``): ``experiment_state.npz`` (pool arrays + init
key), ``aux_state.msgpack`` (the sampler's own state,
``Strategy.aux_state_bytes``: VAAL's VAE, discriminator and their
optimizers) and ``experiment_state.json`` (round, rng state, config
echo, metrics key, best epoch) under
``{ckpt_path}/{exp_name}_{exp_hash}``, each an atomic tmp + rename,
meta last, with the ``ckpt_write`` fault site and its torn point before
the meta; a stale aux file is removed when the sampler has none.  The
port writes the JAX package's keys and layouts, and each package loads
the other's state.

``init_key`` means different things in the two packages: the JAX
package stores a threefry key, the port its ``(seed, inits)``.  The
port marks its own with ``init_key_kind`` in the json (which the JAX
loader ignores); a state without the mark holds a JAX key, which the
port re-seeds its init stream from (crc32 of the key's bytes, init
count 0) and says so in the log.  The torch weight init differs from
flax's in any case, so later rounds' initial weights differ across
packages.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Optional

import numpy as np

from .. import faults
from ..config import ExperimentConfig, config_to_dict
from ..pool import PoolState
from ..train.checkpoint import MODEL_FORMAT_VERSION
from ..utils.logging import get_logger

STATE_FILE = "experiment_state.npz"
META_FILE = "experiment_state.json"
AUX_FILE = "aux_state.msgpack"
# experiment_state.json's mark of a port-written init_key.
PORT_INIT_KEY = "port_seed_inits"


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
    faults.site("ckpt_write")
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
    # Torn point between the npz and the meta: a crash here leaves a
    # round-N state with older (or no) meta, which has_saved_experiment
    # and the meta-last order read as the last complete round.
    faults.site("ckpt_write", point="torn")
    meta = {
        "round": int(strategy.round),
        "model_format": MODEL_FORMAT_VERSION,
        "rng_state": strategy.rng.bit_generator.state,
        "config": {k: _jsonable(v) for k, v in config_to_dict(cfg).items()},
        "experiment_key": getattr(strategy.sink, "experiment_key", None),
        "best_epoch": int(strategy.best_epoch),
        "init_key_kind": PORT_INIT_KEY,
    }
    meta_path = os.path.join(directory, META_FILE)
    with open(meta_path + ".tmp", "w") as fh:
        json.dump(meta, fh, indent=2)
    os.replace(meta_path + ".tmp", meta_path)
    get_logger().info(f"Saved experiment state for round {strategy.round} "
                      f"to {directory}")
    return directory


def has_saved_experiment(cfg: ExperimentConfig) -> bool:
    d = state_dir(cfg)
    return (os.path.exists(os.path.join(d, STATE_FILE))
            and os.path.exists(os.path.join(d, META_FILE)))


def load_experiment(strategy, cfg: ExperimentConfig) -> int:
    """Restore ``strategy`` in place from the last completed round;
    returns the round to resume from."""
    logger = get_logger()
    directory = state_dir(cfg)
    with np.load(os.path.join(directory, STATE_FILE)) as arrs:
        arrays = {k: arrs[k] for k in arrs.files}
    with open(os.path.join(directory, META_FILE)) as fh:
        meta = json.load(fh)

    saved_fmt = int(meta.get("model_format", 1))
    if saved_fmt != MODEL_FORMAT_VERSION:
        # The shapes would match and the run would silently diverge.
        raise RuntimeError(
            f"Saved experiment in {directory} uses model format "
            f"{saved_fmt}, this code writes {MODEL_FORMAT_VERSION}: its "
            "checkpointed weights are not alignment-compatible with the "
            "current conv padding. Restart the experiment (or re-run with "
            "the code version that wrote it).")

    current = {k: _jsonable(v) for k, v in config_to_dict(cfg).items()}
    saved = meta.get("config", {})
    for key in sorted(set(saved) | set(current)):
        if key == "resume_training":
            continue
        if saved.get(key) != current.get(key):
            logger.warning(
                f"Resume config mismatch for '{key}': saved "
                f"{saved.get(key)!r} != current {current.get(key)!r}")

    init_key = np.asarray(arrays.pop("init_key"), dtype=np.uint32)
    strategy.pool = PoolState.from_arrays(arrays)
    if meta.get("init_key_kind") == PORT_INIT_KEY:
        strategy.set_init_state(int(init_key[0]), int(init_key[1]))
    else:
        seed = zlib.crc32(init_key.astype("<u4").tobytes()) & 0x7FFFFFFF
        logger.warning(
            f"experiment_state.npz holds a JAX threefry init key "
            f"{init_key.tolist()}, which the port's torch init cannot "
            f"follow: the port's init stream restarts from seed {seed} "
            "(crc32 of the key), init count 0")
        strategy.set_init_state(seed, 0)
    strategy.rng.bit_generator.state = meta["rng_state"]
    strategy.best_epoch = int(meta.get("best_epoch", 0))

    prev_round = int(meta["round"])
    strategy.round = prev_round
    # The completed round's trained model scores the next query.  The
    # model is loaded in place: no init runs, so the init stream is not
    # consumed.
    best = strategy.weight_paths()["best_ckpt"]
    if os.path.exists(best):
        strategy.load_best_ckpt()
    aux_path = os.path.join(directory, AUX_FILE)
    if os.path.exists(aux_path):
        with open(aux_path, "rb") as fh:
            strategy.restore_aux_state(fh.read())
        logger.info("Restored sampler aux state (VAE/discriminator)")
    logger.info(f"Resuming experiment from round {prev_round + 1}")
    return prev_round + 1


def saved_experiment_key(cfg: ExperimentConfig) -> Optional[str]:
    """The metrics experiment key of a saved run (for sink reattachment)."""
    path = os.path.join(state_dir(cfg), META_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh).get("experiment_key")
