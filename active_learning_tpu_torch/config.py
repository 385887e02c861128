"""Typed configs of the port (the JAX package's ``config.py``).

``LoaderConfig``, ``OptimizerConfig``, ``SchedulerConfig``,
``PretrainedConfig`` and ``TrainConfig`` keep the JAX package's field
names and defaults for every field the port reads; ``ExperimentConfig``
keeps the CLI-facing fields of the training slice.  Fields of the JAX
package that steer paths the port does not carry yet (device-resident
feeds, the disk tier, profiling) are left out rather than carried as
dead knobs; the host feed's and the decode caches' fields
(``train_feed``, ``feed_workers``, ``cache_eval_bytes``,
``cache_decoded_bytes``, ``decoded_cache_dir``) keep the JAX package's
names and defaults.  The mesh fields (``num_devices``,
``grad_allreduce``, ``scale_batch`` and the multi-host rendezvous) and
the recovery fields (``resume_training``, ``fault_spec``,
``TrainConfig.current_ckpt_every``) keep the JAX package's names and
defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The online scoring service's knobs (the ``serve`` verb)."""

    host: str = "127.0.0.1"
    # 0 = ephemeral (the bound port is logged and exposed on the server).
    port: int = 8000
    # Rows per dispatched device batch, upper bound.  Served shapes are
    # the bucket ladder serve_buckets(max_batch, bucket_floor), every one
    # warmed at startup.
    max_batch: int = 64
    # Microbatch deadline: a batch closes at max_batch rows or this many
    # ms after its first row, whichever comes first.
    max_latency_ms: float = 5.0
    # Admission bound in ROWS (queued + in flight); beyond it requests
    # get 429 + Retry-After.
    queue_depth: int = 512
    # Floor of the bucket ladder: the smallest padded batch a lone
    # request is served at.
    bucket_floor: int = 8
    # Hot-reload poll cadence for a newer best_rd_{n} checkpoint; 0
    # checks before every batch.
    reload_every_s: float = 5.0
    # Bound on the SIGTERM graceful drain (in-flight completion).
    drain_timeout_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    """Host input-pipeline parameters (the reference's DataLoader
    kwargs): ``num_workers`` gather threads, ``prefetch`` batches in
    flight."""

    batch_size: int = 128
    num_workers: int = 0
    prefetch: int = 2


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer selection, resolved by name in ``train/optim.py``."""

    name: str = "sgd"
    lr: float = 0.1
    weight_decay: float = 5e-4
    momentum: float = 0.9


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """LR schedule stepped once per epoch: "step" (step_size/gamma),
    "cosine" (t_max, optional linear warmup) or "constant"."""

    name: str = "cosine"
    step_size: int = 60
    gamma: float = 0.1
    t_max: int = 200
    warmup_epochs: int = 0


@dataclasses.dataclass(frozen=True)
class PretrainedConfig:
    """SSL / transfer checkpoint ingestion (``utils/pretrained.py``): the
    torch checkpoint's path and the reference's key surgery, keys kept
    when they hold a ``required_key`` substring, dropped when they hold
    a ``skip_key`` one, renamed by the first matching ``replace_key``
    pair."""

    path: Optional[str] = None
    required_key: Optional[Tuple[str, ...]] = None
    skip_key: Optional[Tuple[str, ...]] = None
    replace_key: Optional[Tuple[Tuple[str, str], ...]] = None

    @property
    def replace_map(self) -> Dict[str, str]:
        return dict(self.replace_key or ())


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Per-dataset training hyperparameters: one entry of an arg pool."""

    eval_split: float = 0.01
    # Compute precision of convolutions and activations: "auto" = bf16
    # on the card, float32 on the CPU (models/factory.resolve_dtype).
    dtype: str = "auto"
    # BN batch-statistics precision: "auto" follows the compute dtype
    # (bf16 -> FusedBatchNorm's formula, float32 -> flax's).
    bn_stats_dtype: str = "auto"
    stem: str = "default"
    loader_tr: LoaderConfig = dataclasses.field(default_factory=LoaderConfig)
    loader_te: LoaderConfig = dataclasses.field(
        default_factory=lambda: LoaderConfig(batch_size=100))
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    pretrained: PretrainedConfig = dataclasses.field(
        default_factory=PretrainedConfig)
    imbalanced_training: bool = False
    # "auto"/"on": the fused SGD update (kernel D) for SGD-family
    # optimizers, its state in optim_state_dtype; "off": the JAX
    # package's optax chain, float32 state, which kernel D computes bit
    # for bit at that state.
    fused_optimizer: str = "auto"
    # Momentum-buffer storage dtype on the fused path: "f32" or "bf16".
    optim_state_dtype: str = "f32"
    # Gradient sync over N ranks: "f32" (one flat all_reduce), "int8"
    # (the block-scaled int8 sync; the reduce-scatter wire form above 8
    # ranks), "int8_rs" (always the reduce-scatter form) or "auto" (int8
    # on any multi-rank mesh).  One rank: always f32.  The int8 modes are
    # gated on the learning probe of ``experiment/driver.py``.
    grad_allreduce: str = "f32"
    # Rows per acquisition-scoring batch; None = the evaluation batch
    # (Trainer.eval_batch_size).  Scores are per-example statistics under
    # eval-mode BN, so this changes throughput only.
    score_batch_size: Optional[int] = None
    # Epoch cadence of the current-weights checkpoint and of the
    # mid-round fit state (``Trainer.fit``); a preemption also saves the
    # fit state at the epoch it lands in.
    current_ckpt_every: int = 25
    # The train feed: "auto" or "host" (the prefetched host leg when
    # feed_workers or loader_tr.prefetch allow it, else the serial one;
    # always serial under a batch_hook).  The JAX package's "resident"
    # leg is not ported (ROADMAP.md queue 1 item 5), so "auto" takes the
    # host legs.  Every leg yields the same batch stream.
    train_feed: str = "auto"
    # Gather/decode worker threads of the host train feed; None defers to
    # loader_tr.num_workers.  The device prefetch depth is
    # loader_tr.prefetch.
    feed_workers: Optional[int] = None
    # Decode each disk-backed eval row once a round (the val view is
    # deterministic), up to cache_eval_bytes of RAM; 0 turns it off.
    cache_eval_bytes: int = 4 << 30
    # The experiment-lifetime decode-once memmap of the whole
    # deterministic pool view (al scoring + the test set,
    # data/cache.DecodedPoolCache), applied only when the whole pool fits
    # the byte budget.  dir None -> ~/.cache/al_tpu_decoded.
    cache_decoded_bytes: int = 32 << 30
    decoded_cache_dir: Optional[str] = None

    @property
    def has_pretrained(self) -> bool:
        return self.pretrained.path is not None


@dataclasses.dataclass(frozen=True)
class VAALConfig:
    """VAAL's VAE / discriminator knobs (the reference's parser.py:83-87),
    with the JAX package's defaults."""

    vae_latent_dim: int = 64
    adversary_param: float = 10.0
    lr_vae: float = 5e-5
    lr_discriminator: float = 1e-3


@dataclasses.dataclass(frozen=True)
class ImbalanceConfig:
    """Synthetic class imbalance (the reference's --imbalance_type /
    --imbalance_factor / --imbalance_seed): "exp", "step" or None."""

    imbalance_type: Optional[str] = None
    imbalance_factor: float = 0.1
    imbalance_seed: int = 0


@dataclasses.dataclass
class ExperimentConfig:
    """Top-level experiment configuration (the CLI flags the training
    slice carries, with the JAX package's names and defaults)."""

    exp_name: str = "active_learning"
    exp_hash: Optional[str] = None
    log_dir: str = "./logs"
    ckpt_path: str = "./checkpoint"

    dataset: str = "cifar10"
    # Where the dataset's files are (CIFAR-10: the directory holding, or
    # to hold, cifar-10-batches-py).
    dataset_dir: Optional[str] = None
    arg_pool: str = "default"
    # Root onto which an arg pool's relative pretrained checkpoint path
    # is rebased.
    pretrained_root: Optional[str] = None
    imbalance: ImbalanceConfig = dataclasses.field(
        default_factory=ImbalanceConfig)
    # Fetch CIFAR-10 (md5-checked) when its batches are absent.
    download_data: bool = False
    # The first 50 rows of each split only.
    debug_mode: bool = False

    strategy: str = "RandomSampler"
    rounds: int = 5
    round_budget: int = 5000
    freeze_feature: bool = False
    init_pool_size: int = -1  # -1 => round_budget
    init_pool_type: str = "random"  # "random" | "random_balance"

    model: str = "SSLResNet18"
    # Continue the saved experiment of exp_name/exp_hash under
    # ckpt_path (round state, then a mid-round fit state).
    resume_training: bool = False
    n_epoch: int = 60
    early_stop_patience: int = 30

    # Overrides of the arg pool's TrainConfig; None defers to it.
    dtype: Optional[str] = None
    bn_stats_dtype: Optional[str] = None
    # ResNet stem ("default"/"s2d"); the 10-class datasets keep the
    # CIFAR stem whatever it says.
    stem: Optional[str] = None
    fused_optimizer: Optional[str] = None
    optim_state_dtype: Optional[str] = None
    # Overrides TrainConfig.grad_allreduce ("f32"/"int8"/"int8_rs"/"auto").
    grad_allreduce: Optional[str] = None
    # Large-batch scaling ("auto"/"off"/None = off): auto multiplies the
    # train batch by the rank count (the arg pool's batch becomes per
    # rank), scales lr linearly and raises the cosine warmup to 5 epochs.
    scale_batch: Optional[str] = None
    # Overrides of TrainConfig.train_feed ("auto"/"host") and
    # TrainConfig.feed_workers.
    train_feed: Optional[str] = None
    feed_workers: Optional[int] = None

    # Coreset / BADGE scale controls (the reference's parser.py:74-79):
    # caps on the labeled and unlabeled rows a selection runs over (the
    # unlabeled cap inherits the labeled cap's unused quota), the number
    # of random partitions of the Partitioned samplers, and the picks
    # the deterministic greedy folds per pool pass (1 = sequential; the
    # exact re-check keeps the picks the same for any value).
    subset_labeled: Optional[int] = None
    subset_unlabeled: Optional[int] = None
    partitions: int = 1
    kcenter_batch: int = 8

    vaal: VAALConfig = dataclasses.field(default_factory=VAALConfig)

    # The reference's fixed seeds (eval split 99, init pool 98) and the
    # run's own.
    eval_split_seed: int = 99
    init_pool_seed: int = 98
    run_seed: int = 0

    # "cuda" (the default; raises without a card) or "cpu".
    device: str = "cuda"

    # Ranks of the data-parallel mesh (-1 = every visible card; 1 on the
    # CPU).  More than one rank is one process each: nccl with a card per
    # rank, gloo with --device cpu.
    num_devices: int = -1
    # Multi-process rendezvous (all None: one process, or the ranks the
    # CLI starts itself): host:port of rank 0, the number of processes
    # and this one's rank.  ckpt_path must be shared: rank 0 writes,
    # every rank reads.
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    # Fault injection (``faults/registry.py``): "site:action[@arg]",
    # comma-separated; None defers to $AL_FAULT_SPEC; unset leaves every
    # site a no-op.
    fault_spec: Optional[str] = None

    def resolved_init_pool_size(self) -> int:
        if self.init_pool_size == -1:
            return int(self.round_budget)
        return int(self.init_pool_size)


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    """Flatten a (possibly nested) dataclass config into a plain dict,
    nested fields as ``parent.child`` (the JAX package's echo format)."""
    out: Dict[str, Any] = {}

    def _walk(prefix: str, obj: Any) -> None:
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                _walk(f"{prefix}{f.name}.", getattr(obj, f.name))
        else:
            out[prefix[:-1]] = obj

    _walk("", cfg)
    return out
