"""FID, the Frechet Inception Distance (reference wm_basicsr/metrics/fid.py),
ported from comfyui_keep_tpu/metrics/fid.py: `calculate_fid` is the
Frechet distance between two Gaussians fitted to feature activations;
`extract_inception_features` runs a feature function over batches (the
InceptionV3 of models/inception.py through its make_fid_feature_fn).
"""
import numpy as np
from scipy import linalg

from comfyui_keep_torch.utils.registry import METRIC_REGISTRY


@METRIC_REGISTRY.register()
def calculate_fid(mu1, sigma1, mu2, sigma2, eps=1e-6):
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError("the two Gaussians' shapes differ")
    # sqrtm's `disp` keyword is gone from newer scipy: its default returns
    # the root alone in every version
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu1 - mu2
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def feature_stats(features: np.ndarray):
    """features: (N, D) -> (mu, sigma)."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def extract_inception_features(data_iter, feature_fn):
    """Run feature_fn over batches and concatenate (reference
    fid.py extract_inception_features)."""
    feats = []
    for batch in data_iter:
        f = feature_fn(batch)
        feats.append(f.cpu().numpy() if hasattr(f, "cpu") else np.asarray(f))
    return np.concatenate(feats, axis=0)
