"""MuonAdamW and the optax pieces the ARVC trainer chains around it, as
functional updates over flat parameter dicts (`utils/tree.flatten`).

The port's own copy of `streamvoiceanon_tpu.train.muon`, with the optax
transformations that package builds on written out with optax's
semantics:

* `clip_by_global_norm`: scales by max/norm only when norm >= max (not
  torch's max/(norm + 1e-6), clamped to 1);
* `adamw`: eps outside the square root, bias corrections counting from 1,
  decoupled decay on every AdamW leaf (no mask);
* `muon`: Nesterov momentum, a quintic Newton-Schulz orthogonalisation of
  each (..., m, n) update scaled by sqrt(max(m, n)), decoupled decay;
* `muon_adamw`: routes each leaf by its path keys and squeezed rank, as
  the JAX package's `_is_muon_param`.  A stacked-layer leaf (L, dim), such
  as the layers' norm weights, counts as a matrix when L > 1 and goes to
  Muon, which orthogonalises all L layers' vectors as one L x dim matrix;
  at L = 1 it goes to AdamW.  The port keeps that routing label for label;
* `scale_by_schedule`: the whole update, decay included, times
  schedule(count), count from 0.

On a model-sharded tree (`parallel/mesh.py`) each rank holds its slice of
the sharded leaves, named by a `Shards` (path -> split axis, and the model
group): `global_norm` counts a sharded leaf's squares once over the group
and a replicated leaf's once, and Muon orthogonalises the whole matrix
(the slices all-gathered, Newton-Schulz on every rank, the rank's slice
kept), as the JAX package's update of a sharded leaf computes.  The
element-wise transformations need nothing more.

The element-wise transformations (the clip, AdamW, `apply_updates`) run
over all their leaves at once (`torch._foreach_*`): a few launches a step
in place of a few for every leaf, the same arithmetic element for element.
The global norm is the norm of the leaves' norms, summed in float64:
equal to the sum of squares' root up to float32's rounding.

A transformation is a pair (init, update): init(params) gives its state,
update(grads, state, params) gives (updates, state').  Step counters are
host integers, so no device value is read back to schedule; the scalars
that follow from them are computed in float32, as the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from streamvoiceanon_tpu_torch.parallel.mesh import all_gather_cat, all_reduce_sum
from streamvoiceanon_tpu_torch.utils.tree import Path

Flat = Dict[Path, torch.Tensor]


class Shards(NamedTuple):
    """The model-sharded leaves of a flat tree: path -> the axis split over
    'model', and the model group."""

    axes: Dict[Path, int]
    group: Any


class GradientTransformation(NamedTuple):
    init: Callable[[Flat], Any]
    update: Callable[[Flat, Any, Flat], Tuple[Flat, Any]]


def _f32(x) -> float:
    """A host scalar rounded to float32, as JAX rounds a weak constant."""
    return float(np.float32(x))


def newton_schulz5(g: torch.Tensor, steps: int = 6) -> torch.Tensor:
    """Batched quintic Newton-Schulz orthogonalisation of (..., m, n), in
    float32, transposed while m > n."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g.float()
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.transpose(-1, -2)
    norm = torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True))
    x = x / torch.clamp(norm, min=1e-7)
    for _ in range(steps):
        A = x @ x.transpose(-1, -2)
        B = b * A + c * (A @ A)
        x = a * x + B @ x
    if transposed:
        x = x.transpose(-1, -2)
    return x.to(g.dtype)


def global_norm(tree: Flat, shards: Optional[Shards] = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (unsharded:
    the norm of the leaves' norms, `torch._foreach_norm` summing in float64,
    with no copy of the leaves), in float32; a model-sharded leaf's summed
    over its group."""
    if shards is None or shards.group is None:
        norms = torch._foreach_norm(list(tree.values()), 2, dtype=torch.float64)
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    whole = sum(torch.sum(t * t) for k, t in tree.items() if k not in shards.axes)
    split = sum(torch.sum(t * t) for k, t in tree.items() if k in shards.axes)
    return torch.sqrt(whole + all_reduce_sum(split, shards.group))


def clip_by_global_norm(max_norm: float,
                        shards: Optional[Shards] = None) -> GradientTransformation:
    def update(grads, state, params=None):
        norm = global_norm(grads, shards)
        keep, one = norm < max_norm, torch.ones_like(norm)
        # g / 1 * 1 where kept, else (g / norm) * max_norm, as optax scales
        out = torch._foreach_mul(
            torch._foreach_div(list(grads.values()), torch.where(keep, one, norm)),
            torch.where(keep, one, torch.full_like(norm, max_norm)))
        return dict(zip(grads, out)), state

    return GradientTransformation(lambda params: (), update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: Adam's moments and bias corrections, then + wd * p,
    then times -lr."""

    def init(params):
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params):
        count = state["count"] + 1
        bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(count))
        keys = list(grads)
        g, m0, v0, p = ([t[k] for k in keys] for t in (grads, state["mu"], state["nu"], params))
        add, mul, div = torch._foreach_add, torch._foreach_mul, torch._foreach_div
        mu = add(mul(g, 1 - b1), mul(m0, b1))
        nu = add(mul(mul(g, g), 1 - b2), mul(v0, b2))
        u = div(div(mu, bc1), add(torch._foreach_sqrt(div(nu, bc2)), eps))
        out = mul(add(u, mul(p, weight_decay)), -lr)
        return (dict(zip(keys, out)),
                {"count": count, "mu": dict(zip(keys, mu)), "nu": dict(zip(keys, nu))})

    return GradientTransformation(init, update)


def muon(lr: float = 1e-4, weight_decay: float = 0.01, momentum: float = 0.95,
         nesterov: bool = True, ns_steps: int = 6,
         shards: Optional[Shards] = None) -> GradientTransformation:
    """Muon for >= 2-D leaves: for a (..., m, n) leaf the update is -lr *
    sqrt(max(m, n)) * NS5(momentum grad) - lr * wd * p.  Stacked layers (L,
    m, n) are L batched matrices; leaves of more than 3 dims are
    orthogonalised with their trailing dims flattened.  A model-sharded
    leaf is orthogonalised whole (`Shards`)."""
    axes = shards.axes if shards is not None and shards.group is not None else {}

    def init(params):
        return {"momentum": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params):
        mom, out = {}, {}
        for k, g in grads.items():
            b = state["momentum"][k]
            mom[k] = b + (1.0 - momentum) * (g - b)
            eff = g + momentum * (mom[k] - g) if nesterov else mom[k]
            if k in axes:  # the whole matrix, its columns in rank order
                eff = all_gather_cat(eff, shards.group, axes[k])
            shape = eff.shape
            if eff.ndim > 3:
                eff = eff.reshape(shape[0], shape[1], -1)
            o = newton_schulz5(eff, ns_steps)
            scale = float(max(o.shape[-2], o.shape[-1])) ** 0.5
            upd = -lr * scale * o.reshape(shape)
            if k in axes:
                size = g.shape[axes[k]]
                upd = upd.narrow(axes[k], dist.get_rank(shards.group) * size, size)
            if weight_decay > 0:
                upd = upd - lr * weight_decay * params[k]
            out[k] = upd
        return out, {"momentum": mom}

    return GradientTransformation(init, update)


EXCLUDE_KEYS = ("embedding", "lm_head", "output", "to_logits")


def is_muon_param(path: Path, shape, exclude_keys: Sequence[str] = EXCLUDE_KEYS) -> bool:
    """No path key contains an excluded name, and the shape has at least
    two dims other than 1."""
    if any(ex in k for k in path for ex in exclude_keys):
        return False
    return len([d for d in shape if d != 1]) >= 2


def labels(params: Flat, exclude_keys: Sequence[str] = EXCLUDE_KEYS) -> Dict[Path, str]:
    """'muon' or 'adamw' for every leaf."""
    return {k: "muon" if is_muon_param(k, p.shape, exclude_keys) else "adamw"
            for k, p in params.items()}


def multi_transform(transforms: Dict[str, GradientTransformation],
                    label_fn: Callable[[Flat], Dict[Path, str]]) -> GradientTransformation:
    """Each transformation on the leaves its label names."""

    def part(tree: Flat, lab: Dict[Path, str], name: str) -> Flat:
        return {k: v for k, v in tree.items() if lab[k] == name}

    def init(params):
        lab = label_fn(params)
        return {n: t.init(part(params, lab, n)) for n, t in transforms.items()}

    def update(grads, state, params):
        lab = label_fn(params)
        out, new = {}, {}
        for n, t in transforms.items():
            u, new[n] = t.update(part(grads, lab, n), state[n], part(params, lab, n))
            out.update(u)
        return {k: out[k] for k in grads}, new

    return GradientTransformation(init, update)


def muon_adamw(lr: float = 1e-4, adamw_betas=(0.9, 0.98), adamw_eps: float = 1e-6,
               muon_weight_decay: float = 0.01, adamw_weight_decay: float = 0.01,
               exclude_keys: Sequence[str] = EXCLUDE_KEYS, ns_steps: int = 6,
               shards: Optional[Shards] = None) -> GradientTransformation:
    """Muon for the leaves `is_muon_param` admits, AdamW for the rest."""
    return multi_transform(
        {"muon": muon(lr, muon_weight_decay, ns_steps=ns_steps, shards=shards),
         "adamw": adamw(lr, b1=adamw_betas[0], b2=adamw_betas[1], eps=adamw_eps,
                        weight_decay=adamw_weight_decay)},
        lambda params: labels(params, exclude_keys))


def scale_by_schedule(schedule: Callable[[int], float]) -> GradientTransformation:
    def update(grads, count, params=None):
        step = _f32(schedule(count))
        return {k: step * g for k, g in grads.items()}, count + 1

    return GradientTransformation(lambda params: 0, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: Flat, updates: Flat) -> None:
    """p += u in place, so that every holder of a parameter tensor (the
    decode kernels read raw pointers) sees the new values."""
    torch._foreach_add_(list(params.values()), [updates[k] for k in params])


def exp_decay_schedule(lr: float, gamma: float = 0.999997,
                       min_lr: float = 1e-5) -> Callable[[int], float]:
    """Exponential decay with a floor, as a multiplier of lr: max(lr *
    gamma^step, min_lr) / lr, in float32."""
    f = np.float32

    def schedule(step: int) -> float:
        return float(np.maximum(f(lr) * f(gamma) ** f(step), f(min_lr)) / f(lr))

    return schedule
