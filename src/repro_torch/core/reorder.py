"""Channel reorder (port of ``repro.core.reorder``; paper Sec. 3.1,
"Channel Reorder"; DESIGN.md §3).

Channels with similar statistics are clustered (k-means over per-channel
features of a calibration set) and placed next to each other, so that each
quantization group covers a homogeneous range.  The permutation is per
head: ``QK^T`` and ``S·V`` are computed per head, so only within-head
permutations keep the attention output exact.

Calibration is offline, so the statistics and the clustering are the
reference's numpy code, copied line for line: on the same samples and
seeds the permutations are the reference's, exactly.  Only the weight
fusion works on the port's tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def channel_features(samples: np.ndarray) -> np.ndarray:
    """Per-channel statistics for clustering.

    samples: (N, H, D) K or V activations from the calibration set.
    returns: (H, D, 3) features = [log-range, mean, std].
    """
    s = np.asarray(samples, dtype=np.float64)
    rng = s.max(axis=0) - s.min(axis=0)            # (H, D)
    mean = s.mean(axis=0)
    std = s.std(axis=0)
    return np.stack([np.log(rng + 1e-6), mean, std], axis=-1)


def kmeans(feats: np.ndarray, k: int, iters: int = 32, seed: int = 0) -> np.ndarray:
    """Plain KMeans (numpy; calibration is offline). Returns labels (N,)."""
    n = feats.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)
    # k-means++ init
    centers = [feats[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(((feats[:, None, :] - np.array(centers)[None]) ** 2).sum(-1), axis=1)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(feats[rng.choice(n, p=p)])
    c = np.array(centers)
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d2 = ((feats[:, None, :] - c[None]) ** 2).sum(-1)
        new = d2.argmin(axis=1)
        if (new == labels).all():
            break
        labels = new
        for j in range(k):
            m = labels == j
            if m.any():
                c[j] = feats[m].mean(axis=0)
    return labels


def head_permutation(feats_h: np.ndarray, n_groups: int, seed: int = 0) -> np.ndarray:
    """Permutation of one head's channels: cluster, order clusters by
    centroid range (descending), order channels within a cluster by range
    (descending).  Equal ``group_size`` chunks of the reordered axis then
    hold similar channels, and the high-dispersion channels land in the
    first groups, which the 2-bit plane of a mixed width covers."""
    d = feats_h.shape[0]
    labels = kmeans(feats_h, n_groups, seed=seed)
    rng_feat = feats_h[:, 0]  # log-range
    cluster_rank = {}
    for j in np.unique(labels):
        cluster_rank[j] = -rng_feat[labels == j].mean()
    order = np.lexsort((-rng_feat, np.array([cluster_rank[l] for l in labels])))
    assert order.shape == (d,)
    return order.astype(np.int32)


def compute_permutations(samples: np.ndarray, group_size: int, seed: int = 0) -> np.ndarray:
    """samples: (N, H, D) -> perm (H, D) int32 (per-head channel order)."""
    feats = channel_features(samples)
    h, d, _ = feats.shape
    n_groups = max(d // min(group_size, d), 1)
    return np.stack([head_permutation(feats[i], n_groups, seed=seed + i)
                     for i in range(h)], axis=0)


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    for i in range(perm.shape[0]):
        inv[i, perm[i]] = np.arange(perm.shape[1], dtype=perm.dtype)
    return inv


def expand_kv_perm_for_q(perm_k: np.ndarray, n_q_heads: int) -> np.ndarray:
    """GQA: each KV head serves n_q/n_kv query heads; Q channels must follow
    the permutation of the KV head they attend to."""
    n_kv = perm_k.shape[0]
    rep = n_q_heads // n_kv
    return np.repeat(perm_k, rep, axis=0)


def smooth_factors(samples: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """Per-channel smoothing factor s (the SmoothQuant baseline; paper
    App. 10): with the paper's alpha = 1 the transformation leans wholly on
    the KV cache, s = max|X_ch| (K is divided by s, Q multiplied by s)."""
    s = np.abs(np.asarray(samples, dtype=np.float64)).max(axis=0) ** alpha  # (H, D)
    return np.maximum(s, 1e-5).astype(np.float32)


# ---------------------------------------------------------------- weight fusion

def on_device(a, device) -> torch.Tensor:
    """A calibration array (numpy, possibly read-only, or a tensor) as a
    tensor on ``device``."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a))
    return a.to(device)


def fuse_out_channels(w: torch.Tensor, perm) -> torch.Tensor:
    """Fuse a per-head output-channel permutation into a projection weight.

    w: (..., d_model, H*head_dim), head h's channels in columns
    [h*hd, (h+1)*hd); perm: (H, head_dim), or (..., H, head_dim) for
    layer-stacked weights.  Returns w with its columns permuted, so the
    projection emits channels already reordered."""
    h, hd = perm.shape[-2:]
    w3 = w.reshape(*w.shape[:-1], h, hd)
    idx = on_device(perm, w.device).long().unsqueeze(-3).expand(w3.shape)
    return torch.gather(w3, -1, idx).reshape(w.shape)


def fuse_in_channels(w: torch.Tensor, perm) -> torch.Tensor:
    """Fuse a per-head input-channel permutation into W_o.

    w: (..., H*head_dim, d_model), rows [h*hd, (h+1)*hd) consuming head
    h's channels; perm: (H, head_dim) or (..., H, head_dim)."""
    h, hd = perm.shape[-2:]
    w3 = w.reshape(*w.shape[:-2], h, hd, w.shape[-1])
    idx = on_device(perm, w.device).long().unsqueeze(-1).expand(w3.shape)
    return torch.gather(w3, -2, idx).reshape(w.shape)
