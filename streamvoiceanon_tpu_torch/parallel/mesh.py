"""Device mesh and sharding rules over `torch.distributed`, as the JAX
package's parallel/mesh.py.

One process is one rank, and a rank drives one device.  The ranks form a
2-D ('data', 'model') mesh, laid out row-major (rank = data_index *
n_model + model_index):

* batch rows are split over 'data': a rank keeps the rows of its data
  index, and every rank of one model group holds the same rows; gradients
  are summed over the data group;
* the dual-AR LM's attention heads and FFN hidden dims are split over
  'model', Megatron-style: wqkv / w1 / w3 column-parallel, wo / w2
  row-parallel.  A rank keeps only its slice of each sharded weight, and
  each transformer block does exactly two all-reduces over the model group
  (after `out @ wo` and after the FFN's `@ w2`, `reduce_from_model`); the
  backward pass all-reduces the two column-parallel inputs' gradients
  (`copy_to_model`);
* everything else is replicated.

JAX shards the fused wqkv's last axis contiguously and lets XLA reshard
after the q/k/v split.  An explicit split cannot do that (a contiguous
slice of [q | k | v] is not a set of heads), so `shard_params` gives rank r
the columns of its heads from each of q, k and v: a re-layout of the same
matrix, undone by `gather_params`.  A model-sharded stack is a
`ShardedStack`, a dict of the rank's slices that names its model group; the
blocks read their local head counts from it.

Backends.  `initialize_multihost` uses NCCL when each rank has a card of
its own, and gloo on the CPU and when several ranks share one card (NCCL
refuses two ranks on one device).  The choice is stated and logged; a
backend that fails to initialize raises, with no switch to another.  Gloo
takes CUDA tensors but runs its collectives on the host: an all-reduce or
all-gather of a CUDA tensor is copied to host memory, reduced there and
copied back, with a device synchronization each way, so on the card every
collective of the sharded paths (the blocks' two all-reduces, the
gradients' sum, Newton-Schulz's gathers, the output's gather) goes through
the host.  With two ranks on one H100 (chip_smoke.py phase 10) a 24 KB
all-reduce of the decode took about 2.3 ms: the 7,568 of a 4-source
`BatchServer(n_model=2)` call were two thirds of its time, and a training
step's 82 all-reduces and 10 all-gathers 85 % of the step.  NCCL with one
rank per card is the multi-card path.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from streamvoiceanon_tpu_torch import resolve_device

log = logging.getLogger(__name__)

Spec = Tuple[Optional[str], ...]  # one entry per axis: "model" or None; () replicated


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------


def choose_backend(device: Optional[torch.device], ranks_per_card: int = 1) -> str:
    """gloo on the CPU or when several ranks share a card, NCCL otherwise."""
    if device is None or torch.device(device).type != "cuda" or ranks_per_card > 1:
        return "gloo"
    return "nccl"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> str:
    """`init_process_group` of this process.  With a coordinator address
    ("host:port" or "tcp://host:port") the world size and this process's
    rank are given; with none, torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_WORLD_SIZE) supplies them.
    `device` is the device this rank drives (the card unless given; with
    no card and no device given this raises); the backend follows
    `choose_backend`, counting the ranks on this host against its cards.
    Returns the backend's name."""
    dev = resolve_device(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("initialize_multihost: a coordinator address needs "
                             "num_processes and process_id")
        addr = coordinator_address
        init = addr if addr.startswith("tcp://") else f"tcp://{addr}"
        world, rank, local = num_processes, process_id, num_processes
    else:
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    ranks_per_card = -(-local // cards) if cards else local
    backend = choose_backend(dev, ranks_per_card)
    if backend == "nccl":
        torch.cuda.set_device((rank % local) % cards)
    log.info("initialize_multihost: rank %d of %d, backend %s (%s, %d rank(s) a card)",
             rank, world, backend, dev, ranks_per_card)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return backend


@dataclass
class Mesh:
    """This rank's place in the ('data', 'model') mesh and its two process
    groups (None where the axis has one rank)."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: Optional[object] = None  # the ranks of this model index
    model_group: Optional[object] = None  # the ranks of this data index

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The 2-D mesh of the initialized world, data over what n_model leaves
    (row-major, as the JAX package's `make_mesh`).  With no process group
    initialized, the 1 x 1 mesh of this process.  `device` is this rank's
    (the card unless given).  Every rank must call it, in the same order
    as its other group creations."""
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if (n_data or 1) * n_model != 1:
            raise ValueError(f"make_mesh: a {n_data} x {n_model} mesh needs an initialized "
                             "process group (initialize_multihost)")
        return Mesh(1, 1, 0, dev)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: {n_data} x {n_model} ranks in a world of {world}")
    rank = dist.get_rank()
    mesh = Mesh(n_data, n_model, rank, dev)
    for d in range(n_data):  # every rank creates every group, in one order
        g = dist.new_group([d * n_model + m for m in range(n_model)]) if n_model > 1 else None
        if d == mesh.data_index:
            mesh.model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)]) if n_data > 1 else None
        if m == mesh.model_index:
            mesh.data_group = g
    return mesh


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of x summed over `group` (reduced half types
    summed in float32 under gloo)."""
    wide = x.dtype in (torch.bfloat16, torch.float16) and dist.get_backend(group) == "gloo"
    y = x.to(torch.float32) if wide else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype) if wide else y


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceMean(torch.autograd.Function):
    """Mean over a group forward and backward (the transpose of a mean)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group) / dist.get_world_size(ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product (identity; its gradient is
    all-reduced over the model group)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel product, all-reduced over the model
    group."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """x averaged over `group` (`pmean`), gradient included."""
    return x if group is None else _AllReduceMean.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, no gradient."""
    return x if group is None else _reduce(x.detach(), group)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The pieces of `group`'s ranks concatenated along `dim`, in rank
    order; every rank gets the whole."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

STACKS = ("layers", "fast_layers")
_COL = ("wqkv", "w1", "w3")  # (L, dim, hidden): the hidden (last) axis
_ROW = ("wo", "w2")  # (L, hidden, dim): the hidden (input) axis


class ShardedStack(dict):
    """A stacked-layer weight dict holding one rank's slices, with the
    model group they are split over and its size."""

    def __init__(self, items, group, n_model: int):
        super().__init__(items)
        self.group = group
        self.n_model = n_model


def model_shards(stack) -> int:
    """How many ways a stack's weights are split over 'model' (1 when
    whole)."""
    return stack.n_model if isinstance(stack, ShardedStack) else 1


def model_group(stack):
    return stack.group if isinstance(stack, ShardedStack) else None


def _block_spec(name: str) -> Spec:
    if name in _COL:
        return (None, None, "model")
    if name in _ROW:
        return (None, "model", None)
    return ()


def dual_ar_param_specs(params: Dict) -> Dict:
    """The spec of every leaf of a dual-AR model tree, or of a whole ARVC
    tree holding one under `model`: the transformer stacks' matmul weights
    over 'model' as `_block_spec` says, everything else replicated (())."""

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, keys + (i,)) for i, v in enumerate(tree)]
        if any(s in keys for s in STACKS) and keys[-1] == "w":
            return _block_spec(keys[-2])
        return ()

    return walk(params, ())


def _stack_geometry(dcfg, stack: str) -> Tuple[int, int, int, int]:
    """(n_head, n_local_heads, head_dim, intermediate_size) of a stack."""
    if stack == "layers":
        return dcfg.n_head, dcfg.n_local_heads, dcfg.head_dim, dcfg.intermediate_size
    return (dcfg.fast_n_head, dcfg.fast_n_local_heads, dcfg.fast_head_dim,
            dcfg.fast_intermediate_size)


def _qkv_columns(dcfg, stack: str, n: int, r: int, device) -> torch.Tensor:
    """The wqkv columns of rank r's heads: its slice of q, then of k, then
    of v."""
    H, nl, hd, _ = _stack_geometry(dcfg, stack)
    q, kv = H * hd, nl * hd
    qs, ks = q // n, kv // n
    return torch.cat([torch.arange(r * qs, (r + 1) * qs),
                      q + torch.arange(r * ks, (r + 1) * ks),
                      q + kv + torch.arange(r * ks, (r + 1) * ks)]).to(device)


def check_divisible(dcfg, n: int) -> None:
    """Raises unless every sharded dim of both stacks divides by n."""
    for stack in STACKS:
        H, nl, _, inter = _stack_geometry(dcfg, stack)
        for what, v in (("n_head", H), ("n_local_heads", nl), ("intermediate_size", inter)):
            if v % n:
                raise ValueError(f"shard_params: {stack} {what} {v} does not divide by "
                                 f"n_model {n}")


def _decoder(cfg):
    return getattr(cfg, "decoder", cfg)


def _shard_leaf(x, spec: Spec, mesh: Mesh, dcfg, stack: Optional[str], name):
    if "model" not in spec or mesh.n_model == 1:
        return x
    n, r = mesh.n_model, mesh.model_index
    axis = spec.index("model")
    if name == "wqkv":
        piece = x.index_select(axis, _qkv_columns(dcfg, stack, n, r, x.device))
    else:
        size = x.shape[axis] // n
        piece = x.narrow(axis, r * size, size)
    piece = piece.detach().clone()
    return piece.requires_grad_(x.requires_grad)


def _walk_pair(tree, specs, fn, keys=()):
    """fn(leaf, spec, keys) over a tree and its spec tree, into plain
    dicts and lists."""
    if isinstance(tree, dict):
        return {k: _walk_pair(v, specs[k], fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk_pair(v, s, fn, keys + (i,)) for i, (v, s) in enumerate(zip(tree, specs))]
    return fn(tree, specs, keys)


def _stack_of(keys) -> Optional[str]:
    return next((k for k in keys if k in STACKS), None)


def shard_params(params: Dict, mesh: Mesh, specs: Dict, cfg=None) -> Dict:
    """This rank's share of `params` on the mesh's device: each leaf whose
    spec names 'model' cut to the rank's slice (wqkv by heads, see the
    module docstring; `cfg`, the decoder's or ARVC's config, gives the
    head geometry and is required when a leaf is sharded), the rest as
    they are.  Each transformer stack with a sharded leaf becomes a
    `ShardedStack`.  A leaf that required grad stays a leaf that does."""
    dcfg = _decoder(cfg) if cfg is not None else None
    sharded = mesh.n_model > 1 and bool(leaf_shards(specs))
    if sharded:
        if dcfg is None:
            raise ValueError("shard_params: sharding the LM over 'model' needs its config "
                             "(the head geometry of wqkv)")
        check_divisible(dcfg, mesh.n_model)

    def leaf(x, spec, keys):
        x = x.to(mesh.device) if torch.is_tensor(x) else x
        return _shard_leaf(x, spec, mesh, dcfg, _stack_of(keys), keys[-2] if len(keys) > 1
                           else None)

    out = _walk_pair(params, specs, leaf)
    return _wrap_stacks(out, specs, mesh) if sharded else out


def _wrap_stacks(tree, specs, mesh: Mesh):
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in STACKS and isinstance(v, dict) and leaf_shards(specs[k]):
            out[k] = ShardedStack(v, mesh.model_group, mesh.n_model)
        else:
            out[k] = _wrap_stacks(v, specs[k], mesh)
    return out


def gather_params(params: Dict, mesh: Mesh, specs: Dict, cfg=None) -> Dict:
    """The whole tree back from each rank's share (every rank of the model
    group gets it): `shard_params` undone, wqkv's columns put back in
    their place.  Plain dicts, detached."""
    dcfg = _decoder(cfg) if cfg is not None else None

    def leaf(x, spec, keys):
        x = x.detach()
        if "model" not in spec or mesh.n_model == 1:
            return x
        axis = spec.index("model")
        whole = all_gather_cat(x, mesh.model_group, axis)
        if keys[-2] != "wqkv":
            return whole
        cols = torch.cat([_qkv_columns(dcfg, _stack_of(keys), mesh.n_model, r, x.device)
                          for r in range(mesh.n_model)])
        out = torch.empty_like(whole)
        out.index_copy_(axis, cols, whole)
        return out

    return _walk_pair(params, specs, leaf)


def leaf_shards(specs: Dict, prefix: Tuple = ()) -> Dict:
    """{path: the axis split over 'model'} of the sharded leaves of a spec
    tree, keyed by the paths of `utils/tree.flatten`."""
    if isinstance(specs, (dict, list)):
        items = specs.items() if isinstance(specs, dict) else enumerate(specs)
        out = {}
        for k, v in items:
            out.update(leaf_shards(v, prefix + (k,)))
        return out
    return {prefix: specs.index("model")} if "model" in specs else {}


def replicate(tree, mesh: Mesh):
    """The tree on the mesh's device, whole on every rank."""
    return _map(lambda x: x.to(mesh.device), tree)


def shard_batch(tree, mesh: Mesh):
    """Each leaf's leading (batch) axis cut to this rank's rows over
    'data', on the mesh's device; the batch must divide by n_data."""

    def rows(x):
        x = torch.as_tensor(x)
        B = x.shape[0]
        if B % mesh.n_data:
            raise ValueError(f"shard_batch: a batch of {B} over {mesh.n_data} data ranks")
        n = B // mesh.n_data
        return x[mesh.data_index * n : (mesh.data_index + 1) * n].to(mesh.device)

    return _map(rows, tree)


def global_batch_from_local(local_batch, mesh: Mesh):
    """A rank's own rows of the global batch from its process-local data:
    on the mesh's device, and the same on every rank of a model group (the
    group's first rank's rows, broadcast), as the mesh's layout needs."""

    def rows(x):
        x = torch.as_tensor(x).to(mesh.device).contiguous()
        if mesh.model_group is not None:
            src = mesh.data_index * mesh.n_model
            dist.broadcast(x, src=src, group=mesh.model_group)
        return x

    return _map(rows, local_batch)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree) if tree is not None else None
