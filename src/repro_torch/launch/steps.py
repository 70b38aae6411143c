"""Step builders: the train step (with fp32 gradient accumulation over
microbatches), the data-parallel step whose gradient sync the endpoint
engine schedules (the paper's technique as a first-class feature), and
the prefill / decode steps (the port of ``repro.launch.steps``).  A
``shard_fn`` (``launch.sharding.make_shard_fn``) constrains activations
by logical axes where the reference's does; the identity by default.

A step takes the parameter tree (fp32 leaves, not requiring grad), the
optimizer state and a batch of tensors, and returns them updated: the
optimizer writes the parameters and moments in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.comm.engine import GradSyncEngine
from repro_torch.core.endpoints import Category
from repro_torch.models.layers import no_sharding
from repro_torch.models.model import Model
from repro_torch.models.params import tree_flatten, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamW


def value_and_grad(model: Model, params, batch, remat: bool = True,
                   cast_params_once: bool = False, shard_fn=no_sharding):
    """-> ((loss, metrics), grads): ``model.loss_fn`` and its gradient
    with respect to every leaf of ``params`` (a leaf the loss does not
    reach gets zeros, as ``jax.grad`` gives).  Metrics come back
    detached."""
    leaves, treedef = tree_flatten(params, torch.is_tensor)
    diff = [leaf.detach().requires_grad_() for leaf in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(
            tree_unflatten(treedef, diff), batch, shard_fn=shard_fn,
            remat=remat, cast_params_once=cast_params_once)
        grads = torch.autograd.grad(loss, diff, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for g, leaf in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(treedef, grads)


def make_train_step(model: Model, opt: AdamW, shard_fn=None,
                    remat: bool = True, accum_steps: int = 1,
                    cast_params_once: bool = False):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``accum_steps`` > 1 splits the batch into that many
    microbatches and accumulates their gradients (and metrics) in fp32,
    then takes the mean: one microbatch's activations are live at a
    time.  The split batch and each microbatch go through ``shard_fn``
    with the batch axis, as the reference constrains them."""
    shard_fn = shard_fn or no_sharding

    def grad_fn(params, batch):
        return value_and_grad(model, params, batch, remat=remat,
                              cast_params_once=cast_params_once,
                              shard_fn=shard_fn)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            (_, metrics), grads = grad_fn(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch of {n} rows does not split into "
                                 f"{accum_steps} microbatches")
            size = n // accum_steps
            split = {k: shard_fn(v.reshape((accum_steps, size)
                                           + tuple(v.shape[1:])),
                                 None, "batch", *([None] * (v.dim() - 1)))
                     for k, v in batch.items()}
            grads = metrics = None
            for i in range(accum_steps):
                micro = {k: shard_fn(v[i], "batch",
                                     *([None] * (v.dim() - 2)))
                         for k, v in split.items()}
                (_, m), g = grad_fn(params, micro)
                if grads is None:
                    grads = tree_map(lambda a: a.float(), g,
                                     torch.is_tensor)
                    metrics = dict(m)
                else:
                    grads = tree_map(lambda a, b: a + b.float(), grads,
                                     torch.is_tensor, g)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            inv = 1.0 / accum_steps
            grads = tree_map(lambda a: a * inv, grads, torch.is_tensor)
            metrics = {k: v * inv for k, v in metrics.items()}
        params, opt_state, gnorm = opt.step(grads, opt_state, params)
        metrics = dict(metrics, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model, shard_fn=None,
                      skip_future: bool = False):
    """skip_future=False keeps the masked schedule of every kv block (the
    serving engine enables the triangular one, ``Model.prefill``'s
    default)."""
    shard_fn = shard_fn or no_sharding

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache, shard_fn=shard_fn,
                             skip_future=skip_future)

    return prefill_step


def make_decode_step(model: Model, shard_fn=None):
    """-> decode_step(params, cache, tokens), or (params, cache, embeds)
    for an embeddings-input model."""
    shard_fn = shard_fn or no_sharding
    if model.cfg.input_mode == "embeddings" and not model.cfg.is_encdec:
        def decode_step(params, cache, embeds):
            return model.decode_step(params, cache, embeds=embeds,
                                     shard_fn=shard_fn)
    else:
        def decode_step(params, cache, tokens):
            return model.decode_step(params, cache, tokens=tokens,
                                     shard_fn=shard_fn)
    return decode_step


# --------------------------------------------------------------------------
# Data-parallel step with endpoint-engine gradient sync
# --------------------------------------------------------------------------

def make_ddp_train_step(model: Model, opt: AdamW,
                        group: dist.ProcessGroup = None,
                        category: Category = Category.TWO_X_DYNAMIC,
                        lanes: int = 16, compressor=None):
    """Data-parallel train step: params replicated, each rank takes its
    rows of the global batch, and the gradient all-reduce is scheduled by
    the scalable-endpoints engine (``group``: the process group, None for
    the default one, which must be initialized).  Metrics are averaged
    over the group.  -> (step, engine); step(params, opt_state, batch,
    comp_state) -> (params, opt_state, metrics, comp_state)."""
    engine = GradSyncEngine(category, group=group, lanes=lanes,
                            compressor=compressor, mean=True)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def step(params, opt_state, batch, comp_state):
        n = next(iter(batch.values())).shape[0]
        if n % world:
            raise ValueError(f"global batch of {n} rows does not split "
                             f"over {world} ranks")
        rows = slice(rank * (n // world), (rank + 1) * (n // world))
        local = {k: v[rows] for k, v in batch.items()}
        (_, metrics), grads = value_and_grad(model, params, local)
        grads, comp_state = engine(grads, comp_state)
        params, opt_state, gnorm = opt.step(grads, opt_state, params)
        metrics = dict(metrics, grad_norm=gnorm)
        names = sorted(metrics)
        stacked = torch.stack([metrics[k].float() for k in names])
        dist.all_reduce(stacked, group=group)
        stacked = stacked / world
        metrics = dict(zip(names, stacked.unbind()))
        return params, opt_state, metrics, comp_state

    return step, engine
