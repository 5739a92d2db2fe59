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

`shard_train_step` is the step over a (data, space) mesh, the JAX
package's `shard_train_step` under GSPMD written out by hand: the batch
splits over the data groups (across processes, one rank per share of
them, and within a process over its own groups) and each image's rows
over its group's space slots (`parallel/spatial.Rows`: every convolution
reads halo rows from its neighbours, the pools and upsamples read the
rows their windows need). Every BatchNorm normalises with the whole
batch's statistics, the loss is the global mean and the gradients are
its gradients, summed onto the mesh's first slot and then over the ranks
before Adam, so every rank takes the one-device step on the whole batch.
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
from image_segmenter_tpu_torch.parallel.mesh import split_bounds, to_slot
from image_segmenter_tpu_torch.parallel.spatial import Rows
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
                   imgs, masks, global_batch: Optional[int] = None):
    """(loss, gradients by parameter name, new batch statistics) of the
    U^2-Net loss at `state`'s weights, BatchNorms in train mode.

    imgs (B, 3, H, W) float32 normalized; masks (B, H, W) in [0,1]. Or
    both as row blocks (`parallel/spatial.Rows`, the masks (B, 1, H, W)):
    the forward then runs block by block, each block's BCE is its sum over
    the global count, and the partial losses and, through the blocks'
    copies of the weights, the gradients add up on the state's device.
    global_batch: the images are this process's shard of a batch of that
    size split over the process group (shard_train_step); the statistics,
    loss and gradients are then the whole batch's, the same on every
    rank."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    # the forward moves these copies in place; the state stays as it was
    stats = {k: v.clone() for k, v in state.batch_stats.items()}
    sharded = global_batch is not None
    # a data shard: the whole batch's BatchNorm statistics, the local sum
    # of the loss over the global count, and the gradients summed
    with (U2.batch_norm_sum(D.all_reduce_sum_grad) if sharded
          else contextlib.nullcontext()):
        outs = functional_call(module, {**params, **stats}, (imgs,),
                               {"train": True})
    if isinstance(imgs, Rows):
        first = next(iter(params.values())).device
        batch = global_batch or sum(g[0].shape[0] for g in masks.blocks)
        count = batch * masks.height * masks.width
        loss = torch.stack([
            to_slot(_bce(p, t, count), first)
            for d in outs for p, t in zip(d.flat(), masks.flat())
            if p.shape[2]]).sum()
    else:
        target = masks[:, None]
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
    def train_step(state: TrainState, imgs, masks,
                   global_batch: Optional[int] = None):
        """imgs (B, 3, H, W) float32 normalized; masks (B, H, W) in [0,1];
        or both as row blocks, and global_batch, as in `loss_and_grads`."""
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
    """`train_step` (from `make_train_step`) over `mesh`'s (data, space)
    slots, as the JAX step runs with the batch on P(DATA, SPACE, None,
    None) and the state replicated.

    Each process drives its own rows of the mesh (`local_mesh`; one
    process drives the whole mesh) and is called with the whole batch, as
    the JAX step is. The batch splits over the mesh's data groups as
    `torch.tensor_split` cuts it; this process's groups take their shares,
    and each share's rows split over its group's space slots
    (`parallel/spatial.Rows`). The BatchNorm sums, the loss and the
    gradients add over the slots on the process's first slot, then over
    the processes, so every process returns the one-device step's next
    state and loss on the whole batch, on its first slot, where the state
    must lie. A one-slot local mesh runs the step on whole tensors; with
    one process that is `train_step` itself. `tx` is accepted for the JAX
    signature."""
    del tx
    world = D.process_count()
    local = D.local_mesh(mesh)
    if local.shape[0] * world != mesh.shape[0]:
        raise ValueError(f"shard_train_step: the mesh's data axis has "
                         f"{mesh.shape[0]} groups, this process drives "
                         f"{local.shape[0]} of them over {world} processes")
    if local.size == 1 and world == 1:
        return train_step
    groups = np.nonzero(mesh.processes[:, 0] == D.process_index())[0]

    def step(state: TrainState, imgs: torch.Tensor, masks: torch.Tensor):
        n = imgs.shape[0]
        if n < mesh.shape[0]:
            raise ValueError(f"shard_train_step: a batch of {n} over "
                             f"{mesh.shape[0]} data groups")
        cuts = split_bounds(n, mesh.shape[0])
        lo, hi = cuts[groups[0]][0], cuts[groups[-1]][1]
        global_batch = n if world > 1 else None
        if local.size == 1:
            return train_step(state, imgs[lo:hi], masks[lo:hi],
                              global_batch=global_batch)
        return train_step(state, Rows.split(imgs[lo:hi], local.devices),
                          Rows.split(masks[lo:hi, None], local.devices),
                          global_batch=global_batch)

    return step
