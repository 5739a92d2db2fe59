"""Segmentation training step (U^2-Net family) on one device.

Counterpart of image_segmenter_tpu/pipeline/train.py without the mesh:
the state is a tree of tensors, the step a function of the state and a
batch that returns the next state and the loss, as in the JAX package.
The loss follows the U^2-Net paper: the sum of BCE over the fused output
d0 and all six side outputs, with the network's BatchNorms in train mode
(models/u2net.py). Adam is written out in optax's order of operations
(`optax.adam`, bias correction included).
The step runs on the device of the module and of the batch; float32
stays float32 on the card (`strict_f32`, no TF32).

`shard_train_step` is the data-parallel step: the data axis is the
process group (one rank per data shard, DDP's layout), every BatchNorm
normalises with the whole batch's statistics, the loss is the global
mean and the gradients are summed over the ranks before Adam, so every
rank takes the one-device step on the whole batch. The JAX package also
splits image rows over the space axis (GSPMD partitions the
convolutions); here rows stay whole within a data shard, so a space axis
gives the same step without splitting its work.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from image_segmenter_tpu_torch.models import u2net as U2
from image_segmenter_tpu_torch.models.registry import _seeded_init
from image_segmenter_tpu_torch.parallel import distributed as D
from image_segmenter_tpu_torch.parallel.mesh import split_bounds
from image_segmenter_tpu_torch.utils.backend import strict_f32, true_div

Tree = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Tree        # parameter name -> tensor, on the module's device
    batch_stats: Tree   # BatchNorm running_mean / running_var
    opt_state: dict     # {"count": int, "mu": Tree, "nu": Tree}
    step: int


class Adam:
    """optax.adam(learning_rate) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0):
    `init(params)` and `update(grads, opt_state)` returning (updates,
    opt_state); the updates are added to the parameters."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate

    def init(self, params: Tree) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads: Tree, opt_state: dict):
        b1, b2 = self.B1, self.B2
        count = opt_state["count"] + 1
        # 1 - decay**count in float32, as optax computes it from an int32 count
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * opt_state["mu"][k]
            nu[k] = (1 - b2) * (g * g) + b2 * opt_state["nu"][k]
            mu_hat = true_div(mu[k], bc1)
            nu_hat = true_div(nu[k], bc2)
            updates[k] = mu_hat / (torch.sqrt(nu_hat) + self.EPS) \
                * (-self.learning_rate)
        return updates, {"count": count, "mu": mu, "nu": nu}


def _state_of(module: torch.nn.Module, tx: Adam) -> TrainState:
    """The training state of `module`'s current weights, step 0."""
    params = {k: v.detach().clone() for k, v in module.named_parameters()}
    stats = {k: v.detach().clone() for k, v in module.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return TrainState(params, stats, tx.init(params), 0)


def create_train_state(module: torch.nn.Module, seed: int,
                       input_hw=(320, 320), learning_rate: float = 1e-3):
    """(tx, state): the module seeded in place as models/registry seeds a
    session (one explicit CPU generator, Flax's initialisers) and Adam at
    `learning_rate`. `input_hw` is the training input's size, kept for the
    JAX signature: the weights do not depend on it."""
    del input_hw
    strict_f32()
    _seeded_init(module, seed)
    tx = Adam(learning_rate)
    return tx, _state_of(module, tx)


def _bce(pred: torch.Tensor, target: torch.Tensor,
         count: Optional[int] = None) -> torch.Tensor:
    """Mean BCE; with `count`, the sum over `count` (a shard's share of
    the global mean)."""
    eps = 1e-7
    p = torch.clamp(pred, eps, 1.0 - eps)
    terms = target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)
    if count is None:
        return -torch.mean(terms)
    return -(torch.sum(terms) / count)


def loss_and_grads(module: torch.nn.Module, state: TrainState,
                   imgs: torch.Tensor, masks: torch.Tensor,
                   global_batch: Optional[int] = None):
    """(loss, gradients by parameter name, new batch statistics) of the
    U^2-Net loss at `state`'s weights, BatchNorms in train mode.

    imgs (B, 3, H, W) float32 normalized; masks (B, H, W) in [0,1].
    global_batch: the images are this process's shard of a batch of that
    size split over the process group (shard_train_step); the statistics,
    loss and gradients are then the whole batch's, the same on every
    rank."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    # the forward moves these copies in place; the state stays as it was
    stats = {k: v.clone() for k, v in state.batch_stats.items()}
    target = masks[:, None]
    sharded = global_batch is not None
    # a data shard: the whole batch's BatchNorm statistics, the local sum
    # of the loss over the global count, and the gradients summed
    with (U2.batch_norm_sum(D.all_reduce_sum_grad) if sharded
          else contextlib.nullcontext()):
        outs = functional_call(module, {**params, **stats}, (imgs,),
                               {"train": True})
    count = global_batch * target[0].numel() if sharded else None
    loss = sum(_bce(d, target, count) for d in outs)
    grads = torch.autograd.grad(loss, list(params.values()))
    loss = loss.detach()
    if sharded:
        flat = D.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
        grads = [g.view_as(p) for g, p in zip(
            torch.split(flat, [g.numel() for g in grads]), params.values())]
        loss = D.all_reduce_sum(loss.reshape(1))[0]
    return loss, dict(zip(params, grads)), stats


def make_train_step(module: torch.nn.Module, tx: Adam):
    def train_step(state: TrainState, imgs: torch.Tensor, masks: torch.Tensor,
                   global_batch: Optional[int] = None):
        """imgs (B, 3, H, W) float32 normalized; masks (B, H, W) in [0,1];
        global_batch as in `loss_and_grads`."""
        loss, grads, stats = loss_and_grads(module, state, imgs, masks,
                                            global_batch)
        updates, new_opt = tx.update(grads, state.opt_state)
        new_params = {k: p + updates[k] for k, p in state.params.items()}
        return TrainState(new_params, stats, new_opt, state.step + 1), loss

    return train_step


def save_checkpoint(path: str, state: TrainState) -> None:
    """Persist a training state as plain tensors (torch.save)."""
    torch.save(state._asdict(), path)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """The state saved at `path`, on the devices of `template`'s tensors;
    raises if its names differ from the template's."""
    dev = next(iter(template.params.values())).device
    restored = torch.load(path, map_location=dev, weights_only=True)
    for part in ("params", "batch_stats"):
        if set(restored[part]) != set(getattr(template, part)):
            raise ValueError(f"checkpoint {path}: its {part} do not match "
                             "the template's")
    return TrainState(**restored)


def shard_train_step(train_step, mesh, tx=None):
    """The data-parallel form of `train_step` (from `make_train_step`)
    over `mesh`'s data axis.

    The data axis is the process group (`parallel/distributed.initialize`;
    `hybrid_mesh` lays it out): its size must be the number of processes.
    Each rank is called with the whole batch, as the JAX step is, and
    computes on its `torch.tensor_split` share; BatchNorm sums, the loss
    and the gradients are summed across the ranks, so every rank returns
    the same next state and the global loss. Rows stay whole within a
    shard: a space axis > 1 gives the same step (the JAX package's
    row-split convolutions are not ported). With one process this is
    `train_step` itself. `tx` is accepted for the JAX signature."""
    del tx
    world = D.process_count()
    if world == 1:
        return train_step
    if mesh.shape[0] != world:
        raise ValueError(f"shard_train_step: the mesh's data axis has "
                         f"{mesh.shape[0]} shards, the process group "
                         f"{world} ranks")
    rank = D.process_index()

    def step(state: TrainState, imgs: torch.Tensor, masks: torch.Tensor):
        lo, hi = split_bounds(imgs.shape[0], world)[rank]
        return train_step(state, imgs[lo:hi], masks[lo:hi],
                          global_batch=imgs.shape[0])

    return step
