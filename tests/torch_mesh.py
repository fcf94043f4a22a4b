"""Runs the port's mesh code in gloo processes on the CPU, for the port's mesh
tests (tests/test_torch_mesh.py, test_torch_train.py, test_torch_realtime.py).

`run_ranks(scenarios, world, inputs, tmp)` starts `world` processes of this
file, each one rank of a `torch.distributed` gloo world on localhost; every
rank runs the named scenarios in order on its inputs (a pickle) and writes
its results (another pickle), which come back as one list per rank.  Each
process has a timeout of its own: a hang fails the test that started it.
The workers import torch and the port, never JAX.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(scenarios, world: int, inputs: dict, tmp, timeout: float = TIMEOUT_S):
    """[results of rank r: {scenario: its output}] for r < world."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, ",".join(scenarios), str(port),
                               str(r), str(world), str(tmp)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs, failed = [], []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0]
            failed.append(f"rank {r} timed out after {timeout} s")
        logs.append(out)
        if p.returncode:
            failed.append(f"rank {r} exited {p.returncode}")
    if failed:
        raise AssertionError("; ".join(failed) + "\n" + "\n".join(
            f"--- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
    results = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def _numpy(tree):
    import torch

    if torch.is_tensor(tree):
        return tree.detach().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree


def _torch(tree):
    import numpy as np
    import torch

    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_torch(v) for v in tree]
    return tree


def _unflatten(flat, like, prefix=()):
    """The nested tree of `like`'s structure with the leaves of `flat`
    (keyed by `utils/tree.flatten` paths)."""
    if isinstance(like, dict):
        return {k: _unflatten(flat, v, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflatten(flat, v, prefix + (i,)) for i, v in enumerate(like)]
    return flat[prefix]


def forward_train(inp):
    """`arvc.forward_train` on a 2 x 2 mesh: the whole batch's two losses
    and the gathered gradients."""
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.models import arvc
    from streamvoiceanon_tpu_torch.parallel import mesh as M
    from streamvoiceanon_tpu_torch.train import step

    cfg = inp["cfg"]
    mesh = M.make_mesh(n_model=2, device="cpu")
    specs = M.dual_ar_param_specs(inp["arvc_np"])
    params = M.shard_params(step.trainable(P.arvc_params(inp["arvc_np"], "cpu")), mesh,
                            specs, cfg.arvc)
    b = M.shard_batch(_torch(inp["batch"]), mesh)
    cb, tok = arvc.forward_train(params, cfg.arvc, b["content"], b["base_target"],
                                 b["target"], b["x_lens"], b["style"], b["timbre"],
                                 inp["delay"], data_group=mesh.data_group)
    grads = step.sum_over(step.grads_of(cb + tok, params), mesh.data_group)
    whole = M.gather_params(_unflatten(grads, params), mesh, specs, cfg.arvc)
    return {"losses": [float(M.all_reduce_sum(cb, mesh.data_group)),
                       float(M.all_reduce_sum(tok, mesh.data_group))],
            "grads": _numpy(whole),
            "local_wqkv": tuple(params["model"]["layers"]["wqkv"]["w"].shape)}


def muon_update(inp):
    """One clip -> MuonAdamW -> schedule update of a model tree whose
    transformer weights are split over 'model' (2 x 2 mesh), gathered."""
    from streamvoiceanon_tpu_torch.parallel import mesh as M
    from streamvoiceanon_tpu_torch.train import muon
    from streamvoiceanon_tpu_torch.utils.tree import flatten

    dcfg = inp["cfg"].arvc.decoder
    mesh = M.make_mesh(n_model=2, device="cpu")
    specs = M.dual_ar_param_specs(inp["model_np"])
    p = M.shard_params(_torch(inp["model_np"]), mesh, specs, dcfg)
    g = M.shard_params(_torch(inp["grads_np"]), mesh, specs, dcfg)
    shards = muon.Shards(M.leaf_shards(specs), mesh.model_group)
    lr = inp["lr"]
    tx = muon.chain(muon.clip_by_global_norm(inp["clip"], shards),
                    muon.muon_adamw(lr=lr, shards=shards),
                    muon.scale_by_schedule(muon.exp_decay_schedule(lr)))
    fp = flatten(p)
    upd, _ = tx.update(flatten(g), tx.init(fp), fp)
    muon.apply_updates(fp, upd)
    return {"params": _numpy(M.gather_params(p, mesh, specs, dcfg)),
            "norm": float(muon.global_norm(flatten(g), shards))}


def lfq_entropy(inp):
    """`lfq_soft_entropy_loss` of each rank's rows with the usage averaged
    over the world, then averaged over the ranks."""
    import torch.distributed as dist

    from streamvoiceanon_tpu_torch.ops.quantizers import lfq_soft_entropy_loss
    from streamvoiceanon_tpu_torch.parallel.mesh import all_reduce_mean

    h = _torch(inp["h"])
    n = h.shape[0] // dist.get_world_size()
    x = h[dist.get_rank() * n : (dist.get_rank() + 1) * n]
    world = dist.group.WORLD
    return {"loss": float(all_reduce_mean(lfq_soft_entropy_loss(x, group=world), world)),
            "local": float(all_reduce_mean(lfq_soft_entropy_loss(x), world))}


def local_batch(inp):
    """`global_batch_from_local` of rows that differ on every rank: each
    rank's rows after it, on a 2 x 2 mesh."""
    import numpy as np
    import torch.distributed as dist

    from streamvoiceanon_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(n_model=2, device="cpu")
    local = {"x": np.full(inp["shape"], dist.get_rank(), np.int64)}
    return {"x": M.global_batch_from_local(local, mesh)["x"].numpy(),
            "data_index": mesh.data_index}


def trainer_step(inp):
    """`ARVCTrainer(n_model_shards=2)._step` on this rank's rows of a
    feature batch, then its checkpoint (written by rank 0)."""
    import torch.distributed as dist

    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.parallel import mesh as M
    from streamvoiceanon_tpu_torch.train.arvc_trainer import ARVCTrainer, TrainerConfig

    cfg, t = inp["cfg"], inp["trees"]
    trainer = ARVCTrainer(cfg, TrainerConfig(log_dir=inp["log_dir"], n_model_shards=2,
                                             **inp["tcfg"]),
                          P.arvc_params(t["arvc_params"], "cpu"),
                          P.tokenizer_params(t["tokenizer_params"], "cpu"),
                          P.vocoder_params(t["vocoder_params"], "cpu"), device="cpu")
    feats = M.shard_batch(_torch(inp["batch"]), trainer.mesh)
    auxes = [{k: float(v) for k, v in trainer._step(feats, d).items()} for d in inp["delays"]]
    path = trainer.save_checkpoint(os.path.join(inp["log_dir"], "ckpt_sharded"), keep_last=0)
    return {"aux": auxes, "ckpt": path, "rank": dist.get_rank(),
            "mesh": (trainer.mesh.n_data, trainer.mesh.n_model, trainer.mesh.rank),
            "local_w1": tuple(trainer.state.params["model"]["layers"]["w1"]["w"].shape)}


def batch_server(inp):
    """`BatchServer(n_model=2)` greedy on the tiny converter, under each
    config given: the wav and the codes of every batch."""
    from streamvoiceanon_tpu_torch import params as P
    from streamvoiceanon_tpu_torch.models import arvc
    from streamvoiceanon_tpu_torch.parallel import mesh as M
    from streamvoiceanon_tpu_torch.parallel.serving import BatchServer

    t, out = inp["trees"], {}
    recorded, orig = [], arvc.generate

    def generate(*a, **kw):
        recorded.append(orig(*a, **kw))
        return recorded[-1]

    arvc.generate = generate
    try:
        for name, cfg in inp["cfgs"].items():
            cv = P.converter_from_numpy(cfg, t["tokenizer_params"], t["vocoder_params"],
                                        t["arvc_params"], device="cpu")
            server = BatchServer(cv, n_model=2)
            for B in inp["batches"]:
                del recorded[:]
                wav = server.convert(*(x[:B] for x in inp["args"]),
                                     sampling=inp["sampling"], delay=2)
                codes = recorded[0]
                if B % server.mesh.n_data == 0:  # this rank's rows: gather them
                    codes = M.all_gather_cat(codes, server.mesh.data_group, 0)
                out[name, B] = {"wav": wav, "codes": codes.numpy()}
    finally:
        arvc.generate = orig
    return out


def _worker(scenarios: str, port: str, rank: str, world: str, tmp: str) -> None:
    import torch

    from streamvoiceanon_tpu_torch.parallel import mesh as M

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # its import (TensorFlow) takes ~15 s
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    backend = M.initialize_multihost(f"127.0.0.1:{port}", int(world), int(rank),
                                     device="cpu")
    assert backend == "gloo", backend
    fns = {f.__name__: f for f in (forward_train, muon_update, lfq_entropy, local_batch,
                                   trainer_step, batch_server)}
    out = {name: fns[name](inputs[name]) for name in scenarios.split(",")}
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(*sys.argv[1:6])
