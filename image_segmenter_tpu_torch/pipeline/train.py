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

`shard_train_step` (the data x space sharded step) needs the device mesh
and is not in this module.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from image_segmenter_tpu_torch.models.registry import _seeded_init
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


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    eps = 1e-7
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def loss_and_grads(module: torch.nn.Module, state: TrainState,
                   imgs: torch.Tensor, masks: torch.Tensor):
    """(loss, gradients by parameter name, new batch statistics) of the
    U^2-Net loss at `state`'s weights, BatchNorms in train mode.

    imgs (B, 3, H, W) float32 normalized; masks (B, H, W) in [0,1]."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    # the forward moves these copies in place; the state stays as it was
    stats = {k: v.clone() for k, v in state.batch_stats.items()}
    outs = functional_call(module, {**params, **stats}, (imgs,),
                           {"train": True})
    target = masks[:, None]
    loss = sum(_bce(d, target) for d in outs)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), stats


def make_train_step(module: torch.nn.Module, tx: Adam):
    def train_step(state: TrainState, imgs: torch.Tensor, masks: torch.Tensor):
        """imgs (B, 3, H, W) float32 normalized; masks (B, H, W) in [0,1]."""
        loss, grads, stats = loss_and_grads(module, state, imgs, masks)
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
