"""Masked loss / metric functions (port of ``fedml_tpu/core/losses.py``).

Every loss takes a validity ``mask`` because ragged per-client datasets
are packed into padded batches of one shape; masked-out examples add
zero loss and zero gradient. The functions are plain tensor code, so
``torch.func.vmap`` runs them per client.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def _mean_over_mask(values: Tensor, mask: Tensor) -> Tensor:
    denom = torch.clamp(mask.sum(), min=1.0)
    return (values * mask).sum() / denom


def softmax_cross_entropy(
    logits: Tensor, labels: Tensor, mask: Tensor
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Classification loss: the masked mean of -log softmax at the label;
    metrics ``loss``, ``correct`` (masked count), ``count`` and ``acc``."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None])[..., 0]
    loss = _mean_over_mask(-ll, mask)
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    acc = _mean_over_mask(correct, mask)
    return loss, {
        "loss": loss,
        "correct": (correct * mask).sum(),
        "count": mask.sum(),
        "acc": acc,
    }


def token_cross_entropy(
    logits: Tensor, labels: Tensor, mask: Tensor
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token prediction: logits [*, T, V], labels [*, T]. ``mask`` is
    the per-example mask [*] (what the packed batches carry), broadcast
    over time here, or a per-token mask [*, T]. Counts are in tokens."""
    if mask.dim() == labels.dim() - 1:
        mask = mask[..., None].expand(labels.shape)
    return softmax_cross_entropy(logits, labels, mask)


def sigmoid_bce(
    logits: Tensor, labels: Tensor, mask: Tensor
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Multi-label tag prediction: labels multi-hot [*, L]; the masked
    mean over examples of the per-tag binary cross-entropy, computed
    stably as max(z, 0) - z y + log1p(exp(-|z|)); metrics the masked
    true-positive, false-positive and false-negative counts of the
    prediction z > 0 (precision, recall and F1 come from their sums),
    ``count``, and ``correct`` = tp for uniform reporting."""
    labels = labels.to(torch.float32)
    per = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    loss = _mean_over_mask(per.mean(dim=-1), mask)
    pred = (logits > 0).to(torch.float32)
    tp = ((pred * labels).sum(dim=-1) * mask).sum()
    fp = ((pred * (1 - labels)).sum(dim=-1) * mask).sum()
    fn = (((1 - pred) * labels).sum(dim=-1) * mask).sum()
    return loss, {
        "loss": loss,
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "count": mask.sum(),
        "correct": tp,
    }


def pixel_cross_entropy(
    logits: Tensor, labels: Tensor, mask: Tensor, ignore_index: int = 255
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Semantic segmentation (FedSeg): logits [*, H, W, C], labels
    [*, H, W]; ``mask`` is the per-example validity [*], broadcast over
    the pixels. Pixels labelled ``ignore_index`` (the void label 255)
    carry no loss and no metric weight; counts are in valid pixels."""
    pm = mask[..., None, None].expand(labels.shape) * (labels != ignore_index).to(mask.dtype)
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    return token_cross_entropy(logits, safe, pm)


LOSSES = {
    "classification": softmax_cross_entropy,
    "nwp": token_cross_entropy,
    "tag_prediction": sigmoid_bce,
    "segmentation": pixel_cross_entropy,
}
