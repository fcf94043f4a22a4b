"""The `train` kind (`drivers/train.py`) as the harness's CPU tests know
it: its tiny cut, and its faults: a step that returns its state unchanged
(from the first step, or only in the window), half of the batch left out
with the mean taken over the rest, and a content token altered in the
features."""

from portbench.tests import converter

tiny_config = converter.tiny_config
check_config = converter.check_config

TINY = {"batch_size": 2, "profile_s": 0.3,
        "lengths": {"count": 10, "mean_s": 1.0, "sigma": 0.3, "min_s": 0.5, "max_s": 1.5}}


def tiny_traffic(tr: dict) -> dict:
    return dict(tr, **TINY)


def unchanged(mp, root):
    from streamvoiceanon_tpu_torch.train import muon

    mp.setattr(muon, "apply_updates", lambda params, updates: None)


def unchanged_after_setup(mp, root):
    """Steps past the set-up's checked ones return their state unchanged, as
    a fault that sets in once the program is warm would."""
    from streamvoiceanon_tpu_torch.train import muon

    orig, n = muon.apply_updates, {"calls": 0}

    def late(params, updates):
        n["calls"] += 1
        if n["calls"] <= 3:
            orig(params, updates)
    mp.setattr(muon, "apply_updates", late)


def half_batch(mp, root):
    from streamvoiceanon_tpu_torch.models import arvc

    orig = arvc.forward_train

    def half(params, cfg, content, base, target, x_lens, style, timbre, delay, **k):
        h = max(1, content.shape[0] // 2)
        return orig(params, cfg, content[:h], base[:h], target[:h], x_lens[:h], style[:h],
                    timbre[:h], delay, **k)
    mp.setattr(arvc, "forward_train", half)


FAULTS = [unchanged, unchanged_after_setup, half_batch, converter.content]
