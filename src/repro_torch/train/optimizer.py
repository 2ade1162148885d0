"""Optimizers built from scratch: AdamW + Adafactor (the port of
``repro/train/optimizer.py``).

AdamW keeps f32 first/second moments.  Adafactor keeps factored second
moments (row/col statistics) — the low-memory choice: state is
~(d_in + d_out) per matrix instead of d_in·d_out.  Params, gradients and
state are trees of tensors (nested dicts, lists, tuples); the state is
float32 on the params' device, the step an int32 scalar tensor there.

API:
    opt   = adamw(peak_lr=3e-4, ...)
    state = opt.init(params)
    new_params, new_state, stats = opt.update(params, grads, state)
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..launch.mesh import PartitionSpec as P
from ._tree import leaves, tree_map, unzip


def cosine_schedule(peak_lr: float, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    state_specs: Callable  # param_specs tree -> state specs tree


def _step0(params) -> torch.Tensor:
    first = leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def adamw(peak_lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: float = 1.0,
          schedule: Optional[Callable] = None) -> Optimizer:
    lr_fn = schedule or cosine_schedule(peak_lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    def update(params, grads, state):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        lr = lr_fn(step)
        t = step.to(torch.float32)
        # bias corrections in float32, as the reference takes them
        b1c = 1 - torch.pow(_f32(b1, t), t)
        b2c = 1 - torch.pow(_f32(b2, t), t)

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * g32 * g32
            u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), m, v

        res = tree_map(upd, params, grads, state["m"], state["v"])
        new_p, new_m, new_v = unzip(res, params, 3)
        return new_p, {"m": new_m, "v": new_v, "step": step}, \
            {"lr": lr, "grad_norm": gnorm}

    def state_specs(param_specs):
        return {"m": param_specs, "v": param_specs, "step": P()}

    return Optimizer(init, update, state_specs)


def adafactor(peak_lr: float = 1e-3, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0,
              schedule: Optional[Callable] = None) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018)."""
    lr_fn = schedule or cosine_schedule(peak_lr)

    def init(params):
        def stat(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.ndim >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"stats": tree_map(stat, params), "step": _step0(params)}

    def update(params, grads, state):
        step = state["step"] + 1
        lr = lr_fn(step)
        beta = 1.0 - torch.pow(step.to(torch.float32) + 1, -decay)

        def upd_core(p, g, s):
            g32 = g.to(torch.float32)
            g2 = g32 * g32 + eps
            if p.ndim >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                prec = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                u = g32 * torch.rsqrt(torch.clamp(prec, min=eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(torch.clamp(v, min=eps))
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), new_s

        def upd(p, g, s):
            # a stacked (L, ...) leaf updates layer by layer, one level
            # deep: its factored statistics and its RMS clip are per layer
            if p.ndim >= 3:
                outs = [upd_core(p[i], g[i], {k: x[i] for k, x in s.items()})
                        for i in range(p.shape[0])]
                return (torch.stack([o[0] for o in outs]),
                        {k: torch.stack([o[1][k] for o in outs])
                         for k in outs[0][1]})
            return upd_core(p, g, s)

        res = tree_map(upd, params, grads, state["stats"])
        new_p, new_stats = unzip(res, params, 2)
        return new_p, {"stats": new_stats, "step": step}, {"lr": lr}

    def state_specs(param_specs):
        def stat_spec(spec):
            parts = tuple(spec) if spec else ()
            if len(parts) >= 2:
                return {"vr": P(*parts[:-1]),
                        "vc": P(*(parts[:-2] + parts[-1:]))}
            return {"v": spec}

        return {"stats": tree_map(stat_spec, param_specs), "step": P()}

    return Optimizer(init, update, state_specs)


def sgd(lr: float = 1e-2) -> Optimizer:
    """Plain SGD (tests / tiny examples)."""
    def init(params):
        return {"step": _step0(params)}

    def update(params, grads, state):
        new_p = tree_map(
            lambda p, g: (p.to(torch.float32)
                          - lr * g.to(torch.float32)).to(p.dtype),
            params, grads)
        return new_p, {"step": state["step"] + 1}, {}

    def state_specs(param_specs):
        return {"step": P()}

    return Optimizer(init, update, state_specs)
