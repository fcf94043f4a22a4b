"""The ARVC training step: loss -> gradients -> optimizer update, as the JAX
package's train/step.py.

The parameters are a nested dict of leaf tensors that require grad
(`trainable`); a step takes the gradients of every leaf with
`torch.autograd.grad` (a leaf the loss does not reach gets zeros, as under
`jax.grad`) and updates the leaves in place (`muon.apply_updates`).

Over a mesh (`parallel/mesh.py`) each rank holds its rows of the batch and
its share of the tree: the losses are normalised over the whole batch, the
gradients summed over the data group (one all-reduce of all of them), as
XLA reduces the gradient of a batch sharded over 'data', and the
gradients' norm counts each model-sharded leaf once (`muon.Shards`).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from streamvoiceanon_tpu_torch.config import ARVCConfig
from streamvoiceanon_tpu_torch.models import arvc
from streamvoiceanon_tpu_torch.parallel.mesh import all_reduce_sum
from streamvoiceanon_tpu_torch.train import muon
from streamvoiceanon_tpu_torch.utils.profiling import span
from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map


class TrainState(NamedTuple):
    params: Dict
    opt_state: Any
    step: int


def trainable(params: Dict, dtype=torch.float32) -> Dict:
    """A copy of a parameter tree in `dtype` whose leaves require grad."""
    return tree_map(lambda t: t.detach().to(dtype).clone().requires_grad_(True), params)


def init_state(params: Dict, optimizer: muon.GradientTransformation) -> TrainState:
    return TrainState(params, optimizer.init(flatten(params)), 0)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01,
                   clip: float = 1000.0) -> muon.GradientTransformation:
    """The AdamW fallback optimizer (MuonAdamW is `muon.muon_adamw`), with
    the reference's gradient clipping at 1000."""
    return muon.chain(muon.clip_by_global_norm(clip),
                      muon.adamw(lr, b1=0.9, b2=0.98, eps=1e-6, weight_decay=weight_decay))


def loss_fn(params: Dict, cfg: ARVCConfig, batch: Dict, delay: int,
            weights: Tuple[float, float] = (1.0, 1.0),
            data_group=None) -> Tuple[torch.Tensor, Dict]:
    """(codebook_weight * codebook CE + semantic_weight * semantic CE, the
    two CEs) of a feature batch (`content`, `base_target`, `target`,
    `x_lens`, `style`, `timbre`): with `data_group`, this rank's share of
    the whole batch's losses."""
    cb, tok = arvc.forward_train(params, cfg, batch["content"], batch["base_target"],
                                 batch["target"], batch["x_lens"], batch["style"],
                                 batch["timbre"], delay, data_group=data_group)
    return weights[0] * cb + weights[1] * tok, {"codebook_loss": cb, "token_loss": tok}


def grads_of(loss: torch.Tensor, params: Dict) -> Dict:
    """{path: gradient} of every leaf of `params`, zeros where unused."""
    flat = flatten(params)
    gs = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(flat.items(), gs)}


def sum_over(grads: Dict, group) -> Dict:
    """Every gradient summed over `group`, in one all-reduce of them all."""
    if group is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    flat = all_reduce_sum(flat, group)
    out, at = {}, 0
    for k, g in grads.items():
        out[k] = flat[at : at + g.numel()].view_as(g)
        at += g.numel()
    return out


def train_step(state: TrainState, batch: Dict, cfg: ARVCConfig,
               optimizer: muon.GradientTransformation, delay: int,
               weights: Tuple[float, float] = (1.0, 1.0), data_group=None,
               shards: Optional[muon.Shards] = None) -> Tuple[TrainState, Dict]:
    """One step.  Returns (state', aux): aux holds the loss, the two CEs
    and `grad_norm`, the global norm of the raw gradients before clipping,
    as device scalars (no host synchronisation).  On a mesh `batch` is this
    rank's rows, `data_group` the ranks its gradients are summed over and
    `shards` the model-sharded leaves; aux is the whole batch's.  The
    loss with its gradients is the span `fwd_bwd`, the update with the aux
    reductions the span `optim` (`utils/profiling.span`)."""
    with span("fwd_bwd"):
        loss, aux = loss_fn(state.params, cfg, batch, delay, weights, data_group)
        grads = sum_over(grads_of(loss, state.params), data_group)
    with span("optim"):
        flat = flatten(state.params)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, flat)
            muon.apply_updates(flat, updates)
        aux = {k: all_reduce_sum(v.detach(), data_group) for k, v in aux.items()}
        aux.update(loss=all_reduce_sum(loss.detach(), data_group),
                   grad_norm=muon.global_norm(grads, shards))
    return TrainState(state.params, opt_state, state.step + 1), aux
