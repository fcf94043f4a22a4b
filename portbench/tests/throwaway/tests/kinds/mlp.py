"""The throwaway `mlp` kind (`drivers/mlp.py`) as the harness's CPU tests
know it: its tiny cut, its faults (an answer altered where it is produced;
half of the batch left out, the rest's rows standing in for it) and its
configuration check."""

from portbench import core


def tiny_config(cfg: dict) -> dict:
    return dict(cfg, dims=[16, 32, 16])


def tiny_traffic(tr: dict) -> dict:
    return dict(tr, batch=8, batches=3, profile_s=0.2)


def check_config(cfg: dict, root) -> None:
    """The driver's weights have the file's widths, in a dtype the harness knows."""
    ws = core.driver({"driver": "mlp"}, root).weights(cfg, 0, "cpu")
    dims = cfg["dims"]
    assert [tuple(w.shape) for w in ws] == list(zip(dims, dims[1:]))
    assert core.DTYPES[cfg["dtype"]].is_floating_point


def _program(mp, root, wrap):
    drv = core.driver({"driver": "mlp"}, root)
    mp.setattr(drv, "forward", wrap(drv.forward))


def altered(mp, root):
    _program(mp, root, lambda fn: lambda ws, x: fn(ws, x) * 1.1)


def half_batch(mp, root):
    _program(mp, root, lambda fn: lambda ws, x: fn(ws, x[:len(x) // 2]).repeat(2, 1))


FAULTS = [altered, half_batch]
