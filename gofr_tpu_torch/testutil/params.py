"""Weights for parity checks: ``init_params`` (and ``transformers``) set
every norm scale to 1 and every bias to 0, so a loader or a layer that
swapped two of them would still agree with its reference. This gives
those leaves distinct values first."""

from __future__ import annotations

import torch


@torch.no_grad()
def perturb_norms_and_biases(tree: dict, gen: torch.Generator) -> None:
    """In place over a nested dict of tensors: every leaf that is all ones
    (a norm scale) to U(0.8, 1.2), every leaf that is all zeros (a bias, a
    norm's shift) to N(0, 0.02). ``gen`` lives on the tensors' device."""
    for v in tree.values():
        if isinstance(v, dict):
            perturb_norms_and_biases(v, gen)
        elif bool((v == 1).all()):
            v.uniform_(0.8, 1.2, generator=gen)
        elif bool((v == 0).all()):
            v.normal_(0.0, 0.02, generator=gen)
