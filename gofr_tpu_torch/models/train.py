"""The training steps (port of ``gofr_tpu/models/train.py``).

Next-token cross-entropy over the port's ``llama.forward`` (plain
attention: the flash kernel has no backward, and the reference's
``_layer`` is plain XLA too), autograd, and AdamW. ``optax.adamw(3e-4)``
becomes ``torch.optim.AdamW``'s arithmetic with optax's defaults
(:func:`adamw`): b1 0.9, b2 0.999, eps 1e-8 and weight decay 1e-4 on every
leaf, norms included (not torch's 1e-2). torch's decoupled decay,
``p -= lr·wd·p`` before the Adam step, is optax's ``update += wd·p`` on
the same ``p``.

The update runs one leaf at a time (``torch.optim.AdamW``'s
``foreach=False`` path, written out in :func:`_adamw_leaf`), so its
temporaries are one leaf's (the ``foreach`` path allocates them across
every leaf at once, gigabytes at Llama-3-8B widths).

``train_step(params, opt_state, tokens)`` keeps the reference's
signature and returns ``(params, opt_state, loss)``. It updates
``params`` and ``opt_state`` in place and returns them, as the
reference's donated form (``sharded_train_step``) does. ``opt_state`` is
the port's own tree: ``{"step", "exp_avg", "exp_avg_sq"}``, the moments
in the parameters' layout and dtype (optax's ``mu``/``nu`` with
``mu_dtype=None``). It checkpoints through ``CheckpointManager`` and
restores within the port only: optax's state tree is another layout.

On a mesh (``parallel/``) each rank steps its own slice of the params
and of the optimizer state. ``sharded_train_step`` splits the batch over
``dp``/``fsdp`` (the pipeline when ``pp > 1``); every rank computes the
same global loss from logits gathered over those axes, so a replicated
parameter's gradient on a rank is its rows' share: it is summed over each
data axis the parameter is not split on (an ``fsdp``-split weight's
gradient is reduce-scattered over ``fsdp`` by the gather at its use).
Gradients of parameters replicated over ``tp`` or ``pp`` are whole on
every rank already (the collectives' backward rules). ``make_moe_train_step``
runs the whole batch on every rank, the expert FFN over ``ep``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from gofr_tpu_torch import tree as tree_util
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.parallel.sharding import ShardingRules, llama_sharding_rules


def adamw(
    learning_rate: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> dict:
    """``optax.adamw``'s settings, as ``torch.optim.AdamW`` names them."""
    return {"lr": learning_rate, "betas": (b1, b2), "eps": eps, "weight_decay": weight_decay}


def _adamw_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, step: int,
                *, lr: float, betas: tuple[float, float], eps: float,
                weight_decay: float) -> None:
    """One AdamW update of one leaf in place, ``torch.optim.AdamW``'s
    single-tensor arithmetic (``foreach=False``) op for op: decoupled
    decay, the moments, then the bias-corrected step. Written out, not
    through a ``torch.optim`` object: an optimizer sits in a reference
    cycle and would hold the params and moments until a garbage
    collection after the caller dropped them."""
    b1, b2 = betas
    p.mul_(1 - lr * weight_decay)
    m.lerp_(g, 1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
    p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shift-by-one next-token negative log-likelihood over [B, S]."""
    targets = tokens[:, 1:].long()
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return nll.mean()


def cross_entropy_loss(cfg: llama.LlamaConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token CE over [B, S] tokens (shift-by-one)."""
    return next_token_nll(llama.forward(cfg, params, tokens), tokens)


def _make_step(loss_fn: Callable[[dict, torch.Tensor], torch.Tensor], optimizer: dict | None,
               sync: Callable[[dict], None] | None = None):
    """Shared step builder: (init_opt_state, train_step) around a
    ``loss_fn(params, tokens) -> scalar``. ``optimizer`` is AdamW's
    settings (:func:`adamw`; its defaults when None). ``sync(params)``
    runs between the backward and the update (the gradients' reduction on
    a mesh)."""
    settings = optimizer or adamw()

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
            if sync is not None:
                sync(params)
            step = int(opt_state["step"])  # a host scalar: no device read
            moments = zip(tree_util.leaves(opt_state["exp_avg"]),
                          tree_util.leaves(opt_state["exp_avg_sq"]))
            with torch.no_grad():
                for p, (m, v) in zip(leaves, moments):
                    _adamw_leaf(p, p.grad, m, v, step + 1, **settings)
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


def _grad_sync(mesh: Any, rules: ShardingRules) -> Callable[[dict], None]:
    """Sum each gradient over the data axes (``dp``, ``fsdp``) its
    parameter is not split on."""
    import torch.distributed as dist

    from gofr_tpu_torch.parallel.sharding import map_with_path, spec_axes

    def sync(params: dict) -> None:
        def one(path: str, p: torch.Tensor) -> None:
            named = set(spec_axes(rules.spec_for(path)))
            for axis in ("dp", "fsdp"):
                if axis not in named and mesh.shape[axis] > 1:
                    dist.all_reduce(p.grad, group=mesh.group(axis))

        map_with_path(one, params)

    return sync


def make_pp_train_step(
    cfg: llama.LlamaConfig, mesh: Any, optimizer: dict | None = None,
    microbatches: int | None = None,
):
    """Pipeline-parallel variant: forward through ``parallel/pipeline.py``'s
    GPipe schedule (the layer stack stage-sharded on pp: this rank's slice
    by ``llama_sharding_rules(pp=True)``), loss, gradients and update as
    usual; autograd runs back through the ppermute ring."""
    from gofr_tpu_torch.parallel.pipeline import pp_forward

    def loss_fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        logits = pp_forward(cfg, params, tokens, mesh, microbatches=microbatches)
        return next_token_nll(logits, tokens)

    return _make_step(loss_fn, optimizer, _grad_sync(mesh, llama_sharding_rules(pp=True)))


def make_moe_train_step(cfg: Any, mesh: Any, optimizer: dict | None = None):
    """MoE training step: CE + Switch-style load-balance aux loss, expert
    FFNs dispatched expert-parallel over the mesh's ep axis."""
    from gofr_tpu_torch.models import moe

    def loss_fn(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        logits, (f, p) = moe.forward(cfg, params, tokens, mesh, return_aux=True)
        aux = moe.load_balance_loss_from_stats(cfg, f, p)
        return next_token_nll(logits, tokens) + cfg.aux_loss_coef * aux

    return _make_step(loss_fn, optimizer)


def sharded_train_step(
    cfg: llama.LlamaConfig,
    mesh: Any,
    rules: ShardingRules | None = None,
    optimizer: dict | None = None,
):
    """The train step over ``mesh``: params and optimizer state are this
    rank's slices by the weight rules (``shard_params``; the state's
    ``exp_avg``/``exp_avg_sq`` mirror the params' paths), tokens the
    global batch, split over (dp, fsdp) inside. When the mesh has a
    non-trivial pp axis the forward runs the GPipe pipeline (and the rules
    must be ``llama_sharding_rules(pp=True)``). Returns (init_opt_state,
    compile_for) as the reference does; ``compile_for(params, opt_state,
    tokens)`` checks the mesh and returns the step."""
    if mesh.shape["sp"] > 1 or mesh.shape["ep"] > 1:
        raise ValueError("sharded_train_step splits the batch over dp/fsdp, the weights over "
                         f"tp/fsdp and the layers over pp; sp={mesh.shape['sp']}, "
                         f"ep={mesh.shape['ep']} are not taken")
    use_pp = mesh.shape["pp"] > 1
    rules = rules or llama_sharding_rules(pp=use_pp)
    if use_pp:
        init_opt_state, train_step = make_pp_train_step(cfg, mesh, optimizer)
    else:
        init_opt_state, train_step = _make_step(
            lambda p, t: next_token_nll(llama.forward(cfg, p, t, mesh=mesh), t), optimizer,
            _grad_sync(mesh, rules))

    def compile_for(params: dict, opt_state: dict, tokens: torch.Tensor):
        llama.data_rows(tokens[:, :1], mesh)  # the batch must split over dp x fsdp
        return train_step

    return init_opt_state, compile_for
