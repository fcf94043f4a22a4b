"""ECAPA-TDNN ASV_eval^anon: the VPC protocol's informed attacker, trained
from random init on anonymized speech, as the JAX package's
evals/ecapa_asv.py.

The backbone is the speaker encoder's ECAPA (`models/speaker_encoder.py`
`ecapa_latents`, SE-Res2 TDNN) on 80-bin Kaldi fbank, followed by
global-context attentive statistics pooling (ASTP), BatchNorm, an
embedding layer and the AAM-softmax centres.  Training runs BatchNorm in
train mode (statistics over batch and time, biased variance); each step
then moves every BatchNorm's running mean and variance by momentum
`bn_momentum` toward that step's statistics, after the optimizer's update
(which decays them too, as optax decays every leaf), so that inference
(`embed`) reads the stored statistics.

The port's trees are in PyTorch's conv layout (`params.ecapa_params`
carries a JAX-layout tree over).  Random draws come from a
`torch.Generator`; batches from numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from streamvoiceanon_tpu_torch.evals.anonymize import fbank_features, tree_device
from streamvoiceanon_tpu_torch.evals.asv_train import (_chunk_batch, aam_softmax_loss,
                                                       adamw_step, leaves, training_set)
from streamvoiceanon_tpu_torch.models import speaker_encoder as se
from streamvoiceanon_tpu_torch.models.campplus import _bn
from streamvoiceanon_tpu_torch.train import muon
from streamvoiceanon_tpu_torch.utils.tree import flatten, tree_map


@dataclasses.dataclass
class ECAPAASVConfig:
    in_dim: int = 80                 # Kaldi fbank features
    channels: int = 512              # ECAPA-small (the VPC eval hparams)
    latent_dim: int = 1536           # multi-scale aggregation width
    attn_dim: int = 128              # ASTP bottleneck
    se_dim: int = 128                # squeeze-excite bottleneck
    emb_dim: int = 192
    res2_scale: int = 8
    # training
    chunk_seconds: float = 3.0
    sample_rate: int = 16000
    batch_size: int = 32
    steps: int = 300
    lr: float = 1e-3
    margin: float = 0.2
    scale: float = 30.0
    weight_decay: float = 1e-4
    bn_momentum: float = 0.9
    seed: int = 0


# ---------------------------------------------------------------------------
# Init (random: the VPC protocol trains the attacker from scratch)
# ---------------------------------------------------------------------------


def _bn_init(c: int, dev) -> Dict:
    return {"mean": torch.zeros((c,), device=dev), "var": torch.ones((c,), device=dev),
            "w": torch.ones((c,), device=dev), "b": torch.zeros((c,), device=dev)}


def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * float(std)


def init_backbone(generator: torch.Generator, cfg: ECAPAASVConfig) -> Dict:
    """He-normal convs (out, in, k) and linears (in, out), zero biases, unit
    BatchNorms: the `se.ecapa_latents` tree."""
    g, dev = generator, generator.device
    C, W = cfg.channels, cfg.channels // cfg.res2_scale

    def conv(kw, cin, cout):
        return _normal(g, (cout, cin, kw), np.sqrt(2.0 / (kw * cin)))

    def res2_layer():
        return {
            "conv1_w": conv(1, C, C), "conv1_b": torch.zeros((C,), device=dev),
            "bn1": _bn_init(C, dev),
            "res2": [{"w": conv(3, W, W), "b": torch.zeros((W,), device=dev),
                      "bn": _bn_init(W, dev)} for _ in range(cfg.res2_scale - 1)],
            "conv2_w": conv(1, C, C), "conv2_b": torch.zeros((C,), device=dev),
            "bn2": _bn_init(C, dev),
            "se1_w": _normal(g, (C, cfg.se_dim), np.sqrt(2.0 / C)),
            "se1_b": torch.zeros((cfg.se_dim,), device=dev),
            "se2_w": _normal(g, (cfg.se_dim, C), np.sqrt(2.0 / cfg.se_dim)),
            "se2_b": torch.zeros((C,), device=dev),
        }

    return {
        "layer1_w": conv(5, cfg.in_dim, C), "layer1_b": torch.zeros((C,), device=dev),
        "layer1_bn": _bn_init(C, dev),
        "layer2": res2_layer(), "layer3": res2_layer(), "layer4": res2_layer(),
        "conv_w": conv(1, 3 * C, cfg.latent_dim),
        "conv_b": torch.zeros((cfg.latent_dim,), device=dev),
    }


def init_head(generator: torch.Generator, cfg: ECAPAASVConfig, n_speakers: int) -> Dict:
    """ASTP, the embedding layer and the AAM class centres."""
    g, dev, L = generator, generator.device, cfg.latent_dim
    return {
        "attn1_w": _normal(g, (3 * L, cfg.attn_dim), np.sqrt(2.0 / (3 * L))),
        "attn1_b": torch.zeros((cfg.attn_dim,), device=dev),
        "attn2_w": _normal(g, (cfg.attn_dim, L), np.sqrt(2.0 / cfg.attn_dim)),
        "attn2_b": torch.zeros((L,), device=dev),
        "pool_bn": _bn_init(2 * L, dev),
        "fc_w": _normal(g, (2 * L, cfg.emb_dim), np.sqrt(1.0 / (2 * L))),
        "fc_b": torch.zeros((cfg.emb_dim,), device=dev),
        "centers": _normal(g, (n_speakers, cfg.emb_dim), 1.0 / np.sqrt(cfg.emb_dim)),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _astp(head: Dict, x: torch.Tensor, mask: Optional[torch.Tensor], bn_fn) -> torch.Tensor:
    """Global-context attentive statistics pooling of x (B, T, L): attention
    over [x; mean; std], the attention-weighted mean and std, BatchNorm,
    then the embedding layer."""
    B, T, L = x.shape
    if mask is None:
        w0 = torch.full((B, T, 1), 1.0 / T, device=x.device)
    else:
        m = mask.to(x.dtype)[..., None]
        w0 = m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    mean = (x * w0).sum(dim=1, keepdim=True)
    std = torch.sqrt(torch.clamp((x * x * w0).sum(dim=1, keepdim=True) - mean ** 2, min=1e-9))
    ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
    a = torch.tanh(ctx @ head["attn1_w"] + head["attn1_b"])
    a = a @ head["attn2_w"] + head["attn2_b"]
    if mask is not None:
        a = torch.where(mask[..., None] > 0, a, torch.full_like(a, -torch.inf))
    a = torch.softmax(a, dim=1)
    mu = (x * a).sum(dim=1)
    sg = torch.sqrt(torch.clamp((x * x * a).sum(dim=1) - mu ** 2, min=1e-9))
    pooled = bn_fn(head["pool_bn"], torch.cat([mu, sg], dim=-1))  # (B, 2L): channels dim 1
    return pooled @ head["fc_w"] + head["fc_b"]


def embed(params: Dict, cfg: ECAPAASVConfig, feat: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feat (B, T, 80) Kaldi fbank -> embedding (B, emb_dim), BatchNorm on
    the stored statistics."""
    lat = se.ecapa_latents(params["backbone"], feat)
    return _astp(params["head"], lat, mask, _bn)


def _forward_train(params: Dict, cfg: ECAPAASVConfig, feat: torch.Tensor):
    """The training forward with batch-statistic BatchNorm: (embedding, each
    BatchNorm's (mean, biased variance) in call order, `_bn_paths`'s)."""
    stats: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def bn_train(p, x, eps=1e-5):
        dims = [d for d in range(x.ndim) if d != 1]  # channels are dim 1
        m = x.mean(dim=dims)
        v = x.var(dim=dims, unbiased=False)
        stats.append((m.detach(), v.detach()))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return ((x - m.view(shape)) * torch.rsqrt(v.view(shape) + eps) * p["w"].view(shape)
                + p["b"].view(shape))

    lat = se.ecapa_latents(params["backbone"], feat, bn_fn=bn_train)
    return _astp(params["head"], lat, None, bn_train), stats


def _bn_paths(cfg: ECAPAASVConfig) -> List[Tuple]:
    """The BatchNorm leaves in `_forward_train`'s call order."""
    paths: List[Tuple] = [("backbone", "layer1_bn")]
    for layer in ("layer2", "layer3", "layer4"):
        paths.append(("backbone", layer, "bn1"))
        paths.extend(("backbone", layer, "res2", i, "bn") for i in range(cfg.res2_scale - 1))
        paths.append(("backbone", layer, "bn2"))
    paths.append(("head", "pool_bn"))
    return paths


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_ecapa_asv(
    utterances: Sequence,               # evals.anonymize.Utterance, anonymized
    cfg: Optional[ECAPAASVConfig] = None,
    utt_sample_rate: int = 44100,
    history: Optional[list] = None,
    device=None,
) -> Dict:
    """AAM-softmax training from random init on anonymized chunks, on
    `device` (the card unless given): {'backbone', 'head'} with the running
    BatchNorm statistics in place, for `embed`."""
    from streamvoiceanon_tpu_torch import resolve_device

    cfg = cfg or ECAPAASVConfig()
    dev = resolve_device(device)
    wavs, labels, n_spk = training_set(utterances, utt_sample_rate, cfg.sample_rate, dev)
    g = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = leaves({"backbone": init_backbone(g, cfg), "head": init_head(g, cfg, n_spk)})
    tx = muon.adamw(cfg.lr, weight_decay=cfg.weight_decay)
    opt_state = tx.init(flatten(params))
    paths = _bn_paths(cfg)
    rng = np.random.default_rng(cfg.seed)
    mom = cfg.bn_momentum
    for _ in range(cfg.steps):
        wav_b, lab_b = _chunk_batch(rng, wavs, labels, cfg)
        feat, _ = fbank_features(torch.from_numpy(wav_b).to(dev))
        e, stats = _forward_train(params, cfg, feat)
        loss = aam_softmax_loss(params["head"], e, torch.from_numpy(lab_b).to(dev),
                                cfg.margin, cfg.scale)
        opt_state = adamw_step(tx, opt_state, params, loss)
        if len(stats) != len(paths):
            raise AssertionError(f"{len(stats)} BatchNorm calls, {len(paths)} paths")
        with torch.no_grad():
            for path, (m, v) in zip(paths, stats):
                bn = _get_path(params, path)
                bn["mean"].mul_(mom).add_((1 - mom) * m)
                bn["var"].mul_(mom).add_((1 - mom) * v)
        if history is not None:
            history.append(float(loss.detach()))
    return tree_map(lambda t: t.detach(), params)


@torch.no_grad()
def extract_embeddings(params: Dict, cfg: ECAPAASVConfig, utterances: Sequence,
                       sample_rate: int = 44100, center: bool = True) -> np.ndarray:
    """Embeddings (N, emb_dim) for the AA scoring, with `center` less the
    set's own mean, as `asv_train.extract_embeddings`."""
    from streamvoiceanon_tpu_torch.audio.resample import resample

    dev = tree_device(params)
    out = []
    for u in utterances:
        w = torch.as_tensor(np.asarray(u.wav, np.float32), device=dev)[None]
        feat, _ = fbank_features(resample(w, sample_rate, cfg.sample_rate))
        out.append(embed(params, cfg, feat)[0].cpu().numpy())
    embs = np.stack(out)
    if center:
        embs = embs - embs.mean(axis=0)
    return embs
