"""The training step (port of ``gofr_tpu/models/train.py``, single card).

Next-token cross-entropy over the port's ``llama.forward`` (plain
attention: the flash kernel has no backward, and the reference's
``_layer`` is plain XLA too), autograd, and AdamW. ``optax.adamw(3e-4)``
becomes ``torch.optim.AdamW`` with optax's defaults (:func:`adamw`): b1
0.9, b2 0.999, eps 1e-8 and weight decay 1e-4 on every leaf, norms
included (not torch's 1e-2). torch's decoupled decay, ``p -= lr·wd·p``
before the Adam step, is optax's ``update += wd·p`` on the same ``p``.

The optimizer runs with ``foreach=False``: one leaf at a time, so its
temporaries are one leaf's (the default ``foreach`` path allocates them
across every leaf at once, gigabytes at Llama-3-8B widths).

``train_step(params, opt_state, tokens)`` keeps the reference's
signature and returns ``(params, opt_state, loss)``. It updates
``params`` and ``opt_state`` in place and returns them, as the
reference's donated form (``sharded_train_step``) does. ``opt_state`` is
the port's own tree: ``{"step", "exp_avg", "exp_avg_sq"}``, the moments
in the parameters' layout and dtype (optax's ``mu``/``nu`` with
``mu_dtype=None``). It checkpoints through ``CheckpointManager`` and
restores within the port only: optax's state tree is another layout.

Waiting for the parallel plane (ROADMAP Queue A item 9):
``make_pp_train_step``, ``make_moe_train_step`` and ``sharded_train_step``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from gofr_tpu_torch import tree as tree_util
from gofr_tpu_torch.models import llama


def adamw(
    learning_rate: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> dict:
    """``optax.adamw``'s settings, as ``torch.optim.AdamW`` takes them."""
    return {"lr": learning_rate, "betas": (b1, b2), "eps": eps, "weight_decay": weight_decay}


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shift-by-one next-token negative log-likelihood over [B, S]."""
    targets = tokens[:, 1:].long()
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()


def cross_entropy_loss(cfg: llama.LlamaConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token CE over [B, S] tokens (shift-by-one)."""
    return next_token_nll(llama.forward(cfg, params, tokens), tokens)


def _make_step(loss_fn: Callable[[dict, torch.Tensor], torch.Tensor], optimizer: dict | None):
    """Shared step builder: (init_opt_state, train_step) around a
    ``loss_fn(params, tokens) -> scalar``. ``optimizer`` is AdamW's
    settings (:func:`adamw`; its defaults when None)."""
    settings = dict(optimizer or adamw(), foreach=False)

    def init_opt_state(params: dict) -> dict:
        return {
            "step": torch.zeros((), dtype=torch.int64),
            "exp_avg": tree_util.tree_map(torch.zeros_like, params),
            "exp_avg_sq": tree_util.tree_map(torch.zeros_like, params),
        }

    def train_step(params: dict, opt_state: dict, tokens: torch.Tensor):
        leaves, treedef = tree_util.flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, tokens)
            loss.backward()
            step = int(opt_state["step"])  # a host scalar: no device read
            opt = torch.optim.AdamW(leaves, **settings)
            moments = zip(tree_util.leaves(opt_state["exp_avg"]),
                          tree_util.leaves(opt_state["exp_avg_sq"]))
            for p, (m, v) in zip(leaves, moments):
                opt.state[p] = {"step": torch.tensor(float(step)), "exp_avg": m,
                                "exp_avg_sq": v}
            opt.step()
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        opt_state["step"] = torch.tensor(step + 1, dtype=torch.int64)
        return params, opt_state, loss.detach()

    return init_opt_state, train_step


def make_train_step(cfg: llama.LlamaConfig, optimizer: dict | None = None):
    """Returns (init_opt_state, train_step):
    (params, opt_state, tokens) -> (params, opt_state, loss)."""
    return _make_step(lambda p, t: cross_entropy_loss(cfg, p, t), optimizer)
