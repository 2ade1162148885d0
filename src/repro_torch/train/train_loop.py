"""Generic training-step factory: grad accumulation + mesh placement (the
port of ``repro/train/train_loop.py``).

``make_train_step`` turns any ``loss_fn(params, batch) -> scalar`` into a
(params, opt_state, batch) -> (params, opt_state, metrics) step with:

  * gradients by ``torch.func.grad_and_value`` over the params tree;
  * microbatch gradient accumulation (static ``accum``): the batch splits
    into ``accum`` microbatches, run in order — live activation memory
    scales with the microbatch, not the global batch;
  * f32 gradient accumulation regardless of param dtype.

Batch leaves that are not tensors (the numpy batches of
:mod:`repro_torch.data`) go to the device of the params.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..data.pipeline import place, placements
from ._tree import leaves, tree_map
from .optimizer import Optimizer


def _split_batch(batch: Dict[str, torch.Tensor], accum: int):
    """(B, ...) -> (accum, B/accum, ...) for every leaf."""
    def split(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"a batch of {b} does not split into {accum} "
                             f"microbatches")
        return x.reshape((accum, b // accum) + tuple(x.shape[1:]))
    return tree_map(split, batch)


def _to_device(batch, device):
    return tree_map(lambda x: x if isinstance(x, torch.Tensor)
                    else torch.as_tensor(x, device=device), batch)


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    accum: int = 1, accum_dtype=torch.float32,
                    donate: bool = True) -> Callable:
    """Build the train step.  ``loss_fn(params, microbatch) -> scalar``.

    ``accum_dtype`` is the dtype of the gradient-accumulation carry (f32
    by default; bf16 halves its memory).  ``donate`` is accepted for the
    JAX signature's sake and does nothing: the step returns new tensors
    and never writes into its inputs."""
    del donate
    value_and_grad = torch.func.grad_and_value(loss_fn)

    def step(params, opt_state, batch):
        batch = _to_device(batch, leaves(params)[0].device)
        if accum == 1:
            grads, loss = value_and_grad(params, batch)
        else:
            mbs = _split_batch(batch, accum)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            for i in range(accum):
                g, l = value_and_grad(params, tree_map(lambda x: x[i], mbs))
                grads = tree_map(lambda a, b: a + b.to(accum_dtype),
                                 grads, g)
                loss = loss + l
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)

        params, opt_state, stats = optimizer.update(params, grads, opt_state)
        metrics = {"loss": loss, **stats}
        return params, opt_state, metrics

    return step


def make_jitted_step(loss_fn, optimizer, mesh, param_specs, *,
                     batch_specs, accum: int = 1):
    """The train step on a mesh (:func:`repro_torch.launch.mesh.make_mesh`)
    -> ``(step, state_specs)``.

    Every rank of the mesh calls ``step`` with the same arguments (SPMD).
    Inputs are tensors, arrays, or DTensors laid out as ``param_specs``,
    ``state_specs`` and ``batch_specs`` say (a DTensor laid out otherwise
    raises ``ValueError``, as a committed array of another sharding does
    in JAX).  Each rank gathers them whole onto its device of the mesh,
    runs :func:`make_train_step`'s step, and returns params and optimizer
    state placed on the mesh by their specs (DTensors; metrics are plain
    tensors).  The numbers are those of the step on one device: every
    rank computes the whole step, and the mesh holds the layout, not a
    partitioned computation.  The name is the JAX package's."""
    from torch.distributed.tensor import DTensor
    from ..launch.mesh import PartitionSpec, check_mesh, mesh_device
    check_mesh(mesh)
    dev = mesh_device(mesh)
    inner = make_train_step(loss_fn, optimizer, accum=accum)
    state_specs = optimizer.state_specs(param_specs)

    def whole(spec, x):
        if not isinstance(x, DTensor):
            return torch.as_tensor(x).to(dev)
        want = tuple(placements(mesh, spec or PartitionSpec(), x.ndim))
        if x.device_mesh != mesh or tuple(x.placements) != want:
            raise ValueError(f"an input laid out as {x.placements} on "
                             f"{x.device_mesh}, where the step takes "
                             f"{spec} on its mesh")
        return x.full_tensor()

    def shard(specs, tree):
        return tree_map(lambda spec, x: place(mesh, x, spec), specs, tree)

    def step(params, opt_state, batch):
        params, opt_state, metrics = inner(
            tree_map(whole, param_specs, params),
            tree_map(whole, state_specs, opt_state),
            {k: whole(batch_specs.get(k), v) for k, v in batch.items()})
        return (shard(param_specs, params), shard(state_specs, opt_state),
                metrics)

    return step, state_specs


def make_eval_step(loss_fn) -> Callable:
    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, _to_device(batch,
                                              leaves(params)[0].device))
    return step


def train(params, opt_state, step_fn, data_iter, *, n_steps: int,
          hooks: Optional[list] = None, start_step: int = 0):
    """Host-side loop with hook points (checkpoint / fault-tolerance /
    metrics).  Hooks: fn(step, params, opt_state, metrics) -> None."""
    hooks = hooks or []
    metrics = {}
    for i in range(start_step, n_steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        for h in hooks:
            h(i, params, opt_state, metrics)
    return params, opt_state, metrics
