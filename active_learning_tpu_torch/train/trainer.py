"""Per-round training (the JAX package's ``train/trainer.py``, host feed).

``Trainer.fit`` trains the model on the labeled subset with a per-epoch
learning rate, validation on the eval split, early stopping, best-weights
tracking and the ``best_rd_{n}`` publish, as the JAX ``fit`` does on its
host-feed leg (trainer.py:1340-1370).  The model object is the state:
its parameters and BatchNorm buffers are updated in place, and the
optimizer (``train/optim.py``) holds the momentum.

A train step: uint8 rows to the device, the train view (crop + flip from
the fit's ``torch.Generator``, then normalize), the forward in training
mode (BatchNorm through kernel C), the weighted cross-entropy, the
backward, the global gradient norm (optax.global_norm) and the update
(kernel D on the fused path).

``fit`` consumes the numpy ``rng`` exactly as the JAX ``fit`` does: one
``rng.integers(0, 2**31 - 1)`` draw seeds the fit's generator (the JAX
fit's PRNG key), then one permutation per epoch orders the batches, so
every later draw of the experiment stays aligned with the reference's.

``batch_hook(epoch, batch)`` runs after each classifier step with the
step's device batch (uint8 images, labels, mask): the seam VAAL trains
its VAE and discriminator through (JAX ``trainer.py:1070``, ``:1371``).

An s2d-stem model (``model.stem == "s2d"``) is fed space-to-depth rows
from the host (JAX ``trainer.py:162-164``), except under a
``batch_hook``: VAAL's VAE is 3-channel, so the hook's batch stays raw
and the model re-lays it on the device.

On a mesh of N ranks (``parallel/mesh.py``) each rank feeds its
contiguous rows of the global batch (padded to a multiple of N) and
draws the global batch's crop and flip, keeping its rows' draws; the
BatchNorms share the global batch's statistics; each rank's loss is its
numerator over the global (all-reduced) weight sum, so the ranks'
gradients sum to the global gradient; the gradients are synced after
the backward and before the norm and the update, by one flat
``all_reduce`` (f32) or the int8 block-scaled sync (``int8`` /
``int8_rs``, JAX ``trainer.py:466-493``).  Every rank ends a step with
the same parameters.  Only the coordinator writes checkpoints; the
others wait at the end of the fit until they are on disk.

Not ported yet (ROADMAP.md): the device-resident and epoch-scan feeds,
and the mid-round fit state and its resume.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..data.augment import apply_view
from ..data.core import Dataset
from ..data.pipeline import iterate_batches
from ..device import resolve_device
from ..models.resnet import set_sync_group
from ..models.weights import to_flax_variables
from ..parallel import mesh as mesh_lib
from ..utils.logging import get_logger
from . import checkpoint as ckpt_lib
from .evaluation import accumulate_metrics, batch_metric_counts
from .optim import make_lr_schedule, make_optimizer


# Epoch cadence of the current-weights checkpoint (the JAX package's
# TrainConfig.current_ckpt_every default, which no arg pool changes).
CURRENT_CKPT_EVERY = 25


@dataclasses.dataclass
class FitResult:
    best_epoch: int
    best_perf: float
    epochs_run: int
    history: List[Dict[str, float]]


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           sample_weights: torch.Tensor,
                           total_weight: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """torch ``CrossEntropyLoss(weight=w, reduction='mean')`` semantics,
    ``sum(w·ce) / sum(w)``, in float32; padding rows carry weight 0.
    ``total_weight`` replaces ``sum(w)`` (a rank's share of a global
    batch divides by the global sum)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ce = -logp.gather(1, labels.to(torch.int64)[:, None])[:, 0]
    denom = torch.clamp(torch.sum(sample_weights) if total_weight is None
                        else total_weight, min=1e-12)
    return torch.sum(ce * sample_weights) / denom


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares
    (optax.global_norm)."""
    return torch.sqrt(torch.stack(
        [torch.sum(t.to(torch.float32) ** 2) for t in tensors]).sum())


class Trainer:
    """Trains one model under one TrainConfig on one rank of ``mesh``
    (default: a single rank on ``device``)."""

    def __init__(self, model: torch.nn.Module, train_cfg: TrainConfig,
                 num_classes: int, device=None,
                 mesh: Optional[mesh_lib.Mesh] = None):
        if mesh is None:
            mesh = mesh_lib.single_rank(device)
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.model = model
        self.cfg = train_cfg
        self.num_classes = num_classes
        self.mesh = mesh
        self.device = mesh.device
        self.logger = get_logger()
        # "f32" or "int8" (one rank: always "f32"), and the int8 wire
        # form; the learning probe (``experiment/driver.py``) may
        # degrade int8 to f32.
        requested = train_cfg.grad_allreduce or "f32"
        self.grad_sync = mesh_lib.resolve_grad_allreduce(requested, mesh)
        self.grad_sync_form = (mesh_lib.resolve_int8_wire(requested, mesh)
                               if self.grad_sync == "int8" else None)
        self.grad_allreduce_degraded = False
        if mesh.world_size > 1:
            set_sync_group(model, mesh)
        self.lr_at = make_lr_schedule(train_cfg.scheduler,
                                      train_cfg.optimizer.lr)
        freeze = bool(getattr(model, "freeze_feature", False))
        # The reference trains with BN in eval mode whenever features are
        # frozen or a pretrained checkpoint is configured.
        train_bn = not (freeze or train_cfg.has_pretrained)
        if not train_bn and not freeze:
            raise NotImplementedError(
                "training with eval-mode BatchNorm and gradients into the "
                "encoder (pretrained fine-tuning) is still to be ported "
                "(ROADMAP.md): it needs a backward for kernel B and the "
                "pretrained checkpoints")
        self.train_bn = train_bn
        self.host_s2d = getattr(model, "stem", "default") == "s2d"
        self.params = list(model.parameters())
        self.optimizer = make_optimizer(train_cfg)
        self.optimizer.init(self.params)

    # -- setup -----------------------------------------------------------

    def padded_batch_size(self, batch_size: int) -> int:
        """Round up so the batch splits evenly over the ranks; padding
        rows are masked out of every reduction."""
        return mesh_lib.padded_batch_size(batch_size, self.mesh)

    def local_rows(self, batch_size: int) -> Optional[slice]:
        """This rank's rows of a global batch (None on one rank)."""
        if self.mesh.world_size == 1:
            return None
        return mesh_lib.process_local_rows(self.mesh, batch_size)

    def eval_batch_size(self, dataset: Optional[Dataset] = None) -> int:
        """The global evaluation batch: the test loader's batch on the
        CPU; on the card at least 512 rows a rank for images up to 64 px
        and 256 above (128 when the row shape is unknown), as the JAX
        package raises it on accelerators; a multiple of the rank count.
        Evaluation is per example under eval-mode BN, so the batch size
        changes throughput only."""
        bs = self.cfg.loader_te.batch_size
        if self.device.type != "cpu":
            floor = 128
            shape = getattr(dataset, "image_shape", None)
            if shape:
                floor = 512 if shape[0] <= 64 else 256
            bs = max(bs, floor * self.mesh.world_size)
        return self.padded_batch_size(bs)

    def class_weights(self, labels: np.ndarray) -> np.ndarray:
        """Imbalanced-training class weights: observed classes get
        total/count, unobserved keep 1, normalized to sum 1; all ones
        when imbalanced_training is off."""
        if not self.cfg.imbalanced_training:
            return np.ones(self.num_classes, dtype=np.float32)
        uniq, counts = np.unique(labels, return_counts=True)
        weights = np.ones(self.num_classes, dtype=np.float64)
        weights[uniq] = counts.sum() / counts
        weights /= weights.sum()
        return weights.astype(np.float32)

    def reinit_optimizer(self) -> None:
        """A fresh optimizer for the round: the momentum buffers are
        zeroed in place, not reallocated."""
        self.optimizer.reset()

    def variables(self) -> Dict[str, torch.Tensor]:
        """A device-side copy of the model's state (params + BN stats)."""
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    # -- steps -----------------------------------------------------------

    def to_device(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def train_step(self, batch: Dict[str, torch.Tensor], lr: float,
                   class_weights: torch.Tensor, view,
                   generator: Optional[torch.Generator],
                   rows: Optional[Tuple[int, slice]] = None):
        """One step on a device batch (with ``rows = (global_b, slice)``:
        this rank's slice of a global batch); returns this rank's share
        of the loss (the shares sum to the global loss) and the global
        gradient norm as device scalars (no host sync)."""
        x = apply_view(batch["image"], view, generator=generator,
                       train=True, rows=rows)
        labels = batch["label"].to(torch.int64)
        weights = class_weights[labels] * batch["mask"]
        total = self.mesh.all_reduce(torch.sum(weights))
        logits = self.model(x)
        loss = weighted_cross_entropy(logits, labels, weights, total)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        # A frozen encoder's parameters get a zero gradient, as JAX's
        # stop_gradient gives them: weight decay and momentum still move
        # them, exactly as in the reference's update.
        grads = [torch.zeros_like(p) if g is None
                 else g if g.stride() == p.stride()
                 else torch.empty_like(p).copy_(g)
                 for g, p in zip(grads, self.params)]
        grads = self.sync_grads(grads)
        gnorm = global_norm(grads)
        self.optimizer.step(self.params, grads, lr)
        return loss.detach(), gnorm

    def sync_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The summed gradients of every rank, the same on each: one
        flat ``all_reduce`` (f32), or the int8 block-scaled sync in the
        resolved wire form.  One rank: ``grads`` as they are."""
        if self.grad_sync == "int8":
            sync = (mesh_lib.int8_reduce_scatter
                    if self.grad_sync_form == "reduce_scatter"
                    else mesh_lib.int8_allreduce)
            return sync(grads, self.mesh)
        return mesh_lib.allreduce_f32(grads, self.mesh)

    def evaluate(self, dataset: Dataset, idxs: np.ndarray
                 ) -> Dict[str, np.ndarray]:
        """Top-1/top-5/per-class metrics over ``dataset[idxs]`` in eval
        mode (the model's mode is restored afterwards)."""
        was_training = self.model.training
        self.model.eval()
        bs = self.eval_batch_size(dataset)

        def counts():
            for batch in iterate_batches(
                    dataset, idxs, bs,
                    num_threads=self.cfg.loader_te.num_workers,
                    prefetch=self.cfg.loader_te.prefetch,
                    s2d=self.host_s2d, rows=self.local_rows(bs)):
                dev = self.to_device(batch)
                x = apply_view(dev["image"], dataset.view, train=False)
                yield batch_metric_counts(self.model(x), dev["label"],
                                          dev["mask"], self.num_classes)

        try:
            with torch.inference_mode():
                return accumulate_metrics(counts(), self.mesh.all_reduce)
        finally:
            self.model.train(was_training)

    def _train_mode(self) -> None:
        self.model.train(self.train_bn)

    # -- the fit loop ----------------------------------------------------

    def fit(self, train_set: Dataset, labeled_idxs: np.ndarray,
            al_set: Dataset, eval_idxs: np.ndarray, n_epoch: int,
            es_patience: int, rng: np.random.Generator, round_idx: int = 0,
            weight_paths: Optional[Dict[str, str]] = None,
            metric_cb: Optional[Callable[[str, float, int], None]] = None,
            batch_hook: Optional[Callable[[int, Dict[str, torch.Tensor]],
                                          None]] = None) -> FitResult:
        """Train on ``train_set[labeled_idxs]`` with per-epoch validation
        on ``al_set[eval_idxs]`` and early stopping.  ``es_patience == 0``
        disables early stopping; the final weights are then the best.
        The model ends at the final epoch's weights; the best are on
        disk at ``weight_paths["best_ckpt"]``."""
        use_es = es_patience != 0 and len(eval_idxs) > 0
        labels = train_set.targets[labeled_idxs]
        class_weights = torch.from_numpy(
            self.class_weights(labels)).to(self.device)
        self.reinit_optimizer()
        bs = self.padded_batch_size(self.cfg.loader_tr.batch_size)
        rows = self.local_rows(bs)
        writer = weight_paths if self.mesh.is_coordinator else None
        best_perf, best_epoch, es_count = 0.0, 0, 0
        best_variables = None
        best_dirty = False
        history: List[Dict[str, float]] = []
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(rng.integers(0, 2 ** 31 - 1)))
        self._train_mode()

        epochs_run = 0
        for epoch in range(1, n_epoch + 1):
            epochs_run = epoch
            lr = float(np.float32(self.lr_at(epoch - 1)))
            losses, gnorms = [], []
            for batch in iterate_batches(
                    train_set, labeled_idxs, bs, shuffle=True, rng=rng,
                    num_threads=self.cfg.loader_tr.num_workers,
                    prefetch=self.cfg.loader_tr.prefetch,
                    s2d=self.host_s2d and batch_hook is None, rows=rows):
                dev_batch = self.to_device(batch)
                loss, gnorm = self.train_step(
                    dev_batch, lr, class_weights, train_set.view, generator,
                    None if rows is None else (bs, rows))
                losses.append(loss)
                gnorms.append(gnorm)
                if batch_hook is not None:
                    batch_hook(epoch, dev_batch)
            train_loss = 0.0
            if losses:
                # Each rank holds its share of every step's loss.
                train_loss = self.mesh.all_reduce(torch.stack(losses)).mean()
            record = {"epoch": epoch, "lr": lr, "train_loss": train_loss,
                      "grad_norm": (torch.stack(gnorms).mean()
                                    if gnorms else 0.0)}
            if use_es:
                perf = self.evaluate(al_set, eval_idxs)
                eval_acc = float(perf["accuracy"])
                eval_top5 = float(perf["top_5_accuracy"])
                record.update(val_accuracy=eval_acc, val_top5=eval_top5)
                self.logger.info(
                    f"\tValidation performance on round {round_idx} at "
                    f"epoch {epoch} is {eval_acc * 100:.2f}%")
                if metric_cb:
                    metric_cb(f"rd_{round_idx}_validation_accuracy",
                              eval_acc, epoch)
                    metric_cb(f"rd_{round_idx}_validation_top5_accuracy",
                              eval_top5, epoch)
                # >= : later epochs win ties.
                if eval_acc >= best_perf:
                    best_perf, best_epoch, es_count = eval_acc, epoch, 0
                    best_variables = self.variables()
                    best_dirty = True
                else:
                    es_count += 1
                if writer and epoch % CURRENT_CKPT_EVERY == 0:
                    if best_dirty:
                        self._publish(writer, best_variables,
                                      round_idx, best_epoch)
                        best_dirty = False
                    ckpt_lib.save_variables(
                        writer["current_ckpt"],
                        to_flax_variables(self.model.state_dict()))
            history.append(record)
            if use_es and es_count > es_patience:
                self.logger.info("Early stopping criterion reached. ")
                break

        if best_variables is None:
            best_epoch = epochs_run
            best_variables = self.variables()
            best_dirty = True
        if best_dirty and writer:
            self._publish(writer, best_variables, round_idx, best_epoch)
        if writer:
            ckpt_lib.save_variables(
                writer["current_ckpt"],
                to_flax_variables(self.model.state_dict()))
        if weight_paths:
            # The other ranks read best_ckpt next: not before it is on
            # disk.
            self.mesh.barrier()
        self.logger.info(
            f"Sanity Check: Best ckpt occurs on epoch {best_epoch}")
        for rec in history:
            rec["train_loss"] = float(rec["train_loss"])
            rec["grad_norm"] = float(rec["grad_norm"])
        self.model.eval()
        return FitResult(best_epoch=best_epoch, best_perf=best_perf,
                         epochs_run=epochs_run, history=history)

    @staticmethod
    def _publish(weight_paths: Dict[str, str],
                 variables: Dict[str, torch.Tensor], round_idx: int,
                 epoch: int) -> None:
        ckpt_lib.publish_best(weight_paths["best_ckpt"],
                              to_flax_variables(variables),
                              round_idx=round_idx, epoch=epoch)
