"""VAAL: Variational Adversarial Active Learning (the JAX package's
``strategies/vaal.py``; reference src/query_strategies/vaal_sampler.py:
15-280, arXiv:1904.00370).

A VAE and a latent discriminator co-train beside the classifier;
acquisition picks the rows the discriminator scores most likely
unlabeled (lowest score first, a stable sort).

Per classifier step (``Trainer.fit``'s ``batch_hook``), one co-step
(``vaal_step``) on the labeled batch and a cycling unlabeled batch:

  1. the VAE step: two training-mode VAE forwards, labeled then
     unlabeled, each its own BatchNorm batch; reconstruction MSE (a mean)
     plus KLD (a sum over batch and latent dims) on each, plus
     ``adversary_param`` x BCE pushing the discriminator's OLD weights to
     call both batches labeled; Adam on the VAE only;
  2. the discriminator step: two more training-mode forwards with the
     updated VAE (running statistics advance l, u, l, u), latents
     detached; BCE labeled -> 1, unlabeled -> 0; Adam.

One crop window serves every VAE call of a step.  The BCE clips its
input at 1e-7 by hand, as the JAX package does.  Padding rows of a
batch enter BatchNorm's statistics but not the masked losses.  Both
Adams follow the classifier's epoch schedule shape at their own base
rates.

Randomness: ``train`` draws ``rng.integers(2**31)`` before the fit, as
the JAX package draws its hook key, and seeds the port's generators with
it (the augmentation, the reparameterization noise and the crop window:
the same distributions as JAX's draws, other numbers); the unlabeled
rows are re-shuffled from the numpy rng each time their iterator runs
dry, as in the JAX package.  The scoring pass crops at the window
``jax.random`` draws from ``PRNGKey(0)`` (``utils/threefry``), so a
224-px pool is scored through the JAX package's window.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import OptimizerConfig
from ..data.augment import apply_view
from ..data.pipeline import iterate_batches
from ..models.vaal import (VAE, Discriminator, crop_size_for, crop_window,
                           draw_window, init_vaal_weights)
from ..models.weights import adam_to_flax, to_flax_vaal
from ..train import checkpoint as ckpt_lib
from ..train.optim import Adam, make_lr_schedule
from ..utils import threefry
from .base import Strategy, register_strategy


def masked_mse(recon, x, mask):
    per_row = ((recon - x) ** 2).mean(dim=(1, 2, 3))
    return (per_row * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_kld(mu, logvar, mask):
    per_row = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=1)
    return (per_row * mask).sum()


def masked_bce(preds, target: float, mask):
    p = torch.clamp(preds.reshape(-1), 1e-7, 1 - 1e-7)
    per = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class VAALModels:
    """The VAE, the discriminator and their Adam states on one device."""

    def __init__(self, z_dim: int, crop: int, device):
        self.vae = VAE(z_dim, 3, crop).to(device)
        self.disc = Discriminator(z_dim).to(device)
        self.vae_params = list(self.vae.parameters())
        self.d_params = list(self.disc.parameters())
        self.vae_opt = Adam(OptimizerConfig(name="adam"))
        self.d_opt = Adam(OptimizerConfig(name="adam"))
        self.vae_opt.init(self.vae_params)
        self.d_opt.init(self.d_params)

    def reinit(self, generator: torch.Generator) -> None:
        """Fresh weights from ``generator`` and fresh optimizer states."""
        init_vaal_weights(self.vae, self.disc, generator)
        self.vae_opt.reset()
        self.d_opt.reset()

    def state_tree(self) -> Dict:
        """The tree ``flax.serialization.to_bytes`` writes for the JAX
        package's ``VAALState`` (numpy leaves)."""
        vae = to_flax_vaal(self.vae.state_dict())
        return {"vae_params": vae["params"],
                "vae_stats": vae["batch_stats"],
                "vae_opt": adam_to_flax(self.vae, self.vae_opt),
                "d_params": to_flax_vaal(self.disc.state_dict())["params"],
                "d_opt": adam_to_flax(self.disc, self.d_opt)}


def vaal_step(m: VAALModels, x_l: torch.Tensor, x_u: torch.Tensor,
              m_l: torch.Tensor, m_u: torch.Tensor,
              eps: List[torch.Tensor], lr_vae: float, lr_d: float,
              adversary: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One co-step on already viewed and cropped NHWC batches ``x_l``,
    ``x_u`` with masks ``m_l``, ``m_u`` and the four forwards'
    reparameterization noise ``eps`` (l, u, then l, u of the
    discriminator step).  Updates ``m`` in place; returns the VAE and
    discriminator losses as device scalars."""
    vae, disc = m.vae, m.disc
    vae.train()
    recon_l, _, mu_l, lv_l = vae(x_l, eps[0])
    recon_u, _, mu_u, lv_u = vae(x_u, eps[1])
    unsup = masked_mse(recon_l, x_l, m_l) + masked_kld(mu_l, lv_l, m_l)
    trans = masked_mse(recon_u, x_u, m_u) + masked_kld(mu_u, lv_u, m_u)
    adv = masked_bce(disc(mu_l), 1.0, m_l) + masked_bce(disc(mu_u), 1.0, m_u)
    vae_loss = unsup + trans + adversary * adv
    grads = torch.autograd.grad(vae_loss, m.vae_params)
    m.vae_opt.step(m.vae_params, grads, lr_vae)

    with torch.no_grad():
        _, _, mu_l, _ = vae(x_l, eps[2])
        _, _, mu_u, _ = vae(x_u, eps[3])
    d_loss = masked_bce(disc(mu_l), 1.0, m_l) + masked_bce(disc(mu_u), 0.0,
                                                            m_u)
    d_grads = torch.autograd.grad(d_loss, m.d_params)
    m.d_opt.step(m.d_params, d_grads, lr_d)
    return vae_loss.detach(), d_loss.detach()


@register_strategy("VAALSampler")
class VAALSampler(Strategy):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.trainer.mesh.world_size > 1:
            raise NotImplementedError(
                "VAALSampler on more than one rank (its VAE and "
                "discriminator co-step is not synced across ranks) is "
                "still to be ported (ROADMAP.md)")
        vcfg = self.cfg.vaal
        h, w = self.al_set.image_shape[:2]
        self.crop = crop_size_for(h)
        if self.crop % 16 != 0:
            raise ValueError(
                f"VAAL needs an input crop divisible by 16, got {self.crop}")
        self.z_dim = int(vcfg.vae_latent_dim)
        self.adversary_param = float(vcfg.adversary_param)
        self.lr_vae_at = make_lr_schedule(self.train_cfg.scheduler,
                                          vcfg.lr_vae)
        self.lr_d_at = make_lr_schedule(self.train_cfg.scheduler,
                                        vcfg.lr_discriminator)
        self.vaal: Optional[VAALModels] = None
        self._vaal_inits = 0
        # The scoring window: jax.random.randint from PRNGKey(0), the
        # column from its fold_in(1) (JAX models/vaal.py::random_crop).
        key = threefry.prng_key(0)
        self.score_window = (
            threefry.randint(key, 0, h - self.crop + 1),
            threefry.randint(threefry.fold_in(key, 1), 0, w - self.crop + 1))
        self.last_losses: Optional[Tuple[float, float]] = None

    # -- state ------------------------------------------------------------

    def _init_vaal(self) -> None:
        """Fresh VAE and discriminator.  The draws come from the init
        seed's stream, apart from the classifier's (bit 62 set)."""
        self._vaal_inits += 1
        gen = torch.Generator().manual_seed(
            (1 << 62) + (self._init_seed << 20) + self._vaal_inits)
        if self.vaal is None:
            self.vaal = VAALModels(self.z_dim, self.crop,
                                   self.trainer.device)
        self.vaal.reinit(gen)

    def init_network_weights(self) -> None:
        """Classifier re-init and a fresh VAE/discriminator every round
        (vaal_sampler.py:72-75)."""
        super().init_network_weights()
        self._init_vaal()

    def aux_state_bytes(self) -> Optional[bytes]:
        if self.vaal is None:
            return None
        return ckpt_lib.msgpack_serialize(self.vaal.state_tree())

    # -- training ---------------------------------------------------------

    def co_step(self, batch_l: Dict[str, torch.Tensor],
                batch_u: Dict[str, torch.Tensor], gen: torch.Generator,
                gen_cpu: torch.Generator, epoch: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The co-step on two device batches of uint8 rows: the train
        view on each (``gen``), one crop window for both (``gen_cpu``),
        the noise of the four forwards (``gen``), the epoch's rates."""
        view = self.train_set.view
        x_l = apply_view(batch_l["image"], view, gen, train=True)
        x_u = apply_view(batch_u["image"], view, gen, train=True)
        oh, ow = draw_window(*x_l.shape[1:3], self.crop, gen_cpu)
        x_l = crop_window(x_l, self.crop, oh, ow)
        x_u = crop_window(x_u, self.crop, oh, ow)
        eps = [torch.randn(x.shape[0], self.z_dim, generator=gen,
                           device=x.device) for x in (x_l, x_u, x_l, x_u)]
        lr_vae = float(np.float32(self.lr_vae_at(epoch - 1)))
        lr_d = float(np.float32(self.lr_d_at(epoch - 1)))
        return vaal_step(self.vaal, x_l, x_u, batch_l["mask"],
                         batch_u["mask"], eps, lr_vae, lr_d,
                         self.adversary_param)

    def train(self) -> None:
        """The base Strategy's training, whose batch hook runs the
        co-step on each labeled batch paired with a cycling unlabeled
        batch (vaal_sampler.py:185-274)."""
        if self.vaal is None:
            self._init_vaal()
        labeled = self.already_labeled_idxs()
        bs = self.train_cfg.loader_tr.batch_size
        dev = self.trainer.device
        seed = int(self.rng.integers(2 ** 31))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        gen_cpu = torch.Generator().manual_seed(seed)
        holder = {"iter": None}

        def next_unlabeled_batch():
            it = holder["iter"]
            batch = next(it, None) if it is not None else None
            if batch is None:
                unlabeled = self.available_query_idxs(shuffle=True)
                if len(unlabeled) == 0:  # pool exhausted: recycle labeled
                    unlabeled = labeled
                holder["iter"] = iterate_batches(self.train_set, unlabeled,
                                                 bs)
                batch = next(holder["iter"])
            return batch

        losses = []

        def batch_hook(epoch: int, batch: Dict[str, torch.Tensor]) -> None:
            batch_u = self.trainer.to_device(next_unlabeled_batch())
            losses.append(self.co_step(batch, batch_u, gen, gen_cpu, epoch))

        super().train(batch_hook=batch_hook)
        if losses:
            self.last_losses = tuple(float(v) for v in losses[-1])

    # -- acquisition ------------------------------------------------------

    def _get_score_step(self, kind: str):
        if kind != "vaal":
            return super()._get_score_step(kind)
        view = self.al_set.view
        crop = self.crop
        oh, ow = self.score_window

        @torch.inference_mode()
        def step(model, batch):
            x = crop_window(apply_view(batch["image"], view, train=False),
                            crop, oh, ow)
            self.vaal.vae.eval()
            _, _, mu, _ = self.vaal.vae(x)
            return {"d_score": self.vaal.disc(mu).reshape(-1)}

        return step

    def query(self, budget: int) -> Tuple[np.ndarray, int]:
        """Lowest discriminator score first (vaal_sampler.py:39-70)."""
        idxs = self.available_query_idxs(shuffle=False)
        if len(idxs) == 0:
            return idxs, 0
        if self.vaal is None:
            self.logger.warning(
                "VAAL has no trained VAE/discriminator; initializing a "
                "fresh one for this query")
            self._init_vaal()
        # The VAE is 3-channel: an s2d-stem classifier must not switch
        # this pass to space-to-depth rows (JAX strategies/vaal.py:330-334).
        scores = self.collect_scores(idxs, "vaal", keys=("d_score",),
                                     host_s2d=False)
        budget = int(min(len(idxs), budget))
        order = np.argsort(scores["d_score"], kind="stable")[:budget]
        self.logger.info(f"Number of queried images: {budget}")
        return idxs[order], budget

