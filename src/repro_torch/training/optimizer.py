"""AdamW for the port's flat ``{"a/b/c": Tensor}`` params: cosine schedule,
global-norm clipping, bias correction, an optional low-precision
(``state_dtype="bfloat16"`` halves the state) or Adafactor-style factored
second moment — the JAX package's ``training/optimizer.py`` in torch.

``update`` runs under ``torch.no_grad()`` and writes the params and the
moments in place (all on the params' device, no host sync, so a CUDA
graph can hold it); it returns them too, with the reference's ``(params,
state, metrics)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.common import torch_dtype


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"        # bfloat16 halves optimizer memory
    factored: bool = False              # Adafactor-style factored v for ≥2D
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warm-up, then cosine decay to ``min_lr_ratio · lr``: step (a
    number or a tensor) → lr, a float32 tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _is_factored(leaf, cfg: AdamWConfig) -> bool:
    return cfg.factored and leaf.dim() >= 2 and \
        leaf.shape[-1] >= 128 and leaf.shape[-2] >= 128


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg

    def init(self, params):
        """``{"mu": {name: {"m", "v"} or {"m", "vr", "vc"}}, "step"}``: zero
        moments at ``state_dtype`` beside each param, and an int32 step."""
        dt = torch_dtype(self.cfg.state_dtype)

        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=dt,  # noqa: E731
                                          device=p.device)
            if _is_factored(p, self.cfg):
                return {"m": z(p.shape), "vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"m": z(p.shape), "v": z(p.shape)}

        dev = next(iter(params.values())).device
        return {"mu": {k: one(p) for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One AdamW step, in place.  Returns (params, state, metrics):
        ``grad_norm`` (before clipping) and ``lr``, device scalars."""
        cfg = self.cfg
        state["step"] += 1
        stepf = state["step"].float()
        lr = cosine_schedule(cfg, stepf)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        # the bases are filled on the device: a host tensor's copy would
        # synchronise, and cannot be captured into a CUDA graph
        bc1 = 1 - torch.pow(torch.full((), cfg.b1, device=stepf.device),
                            stepf)
        bc2 = 1 - torch.pow(torch.full((), cfg.b2, device=stepf.device),
                            stepf)
        for name, p in params.items():
            g = grads[name].float() * scale
            mu = state["mu"][name]
            m = cfg.b1 * mu["m"].float() + (1 - cfg.b1) * g
            if "v" in mu:
                v = cfg.b2 * mu["v"].float() + (1 - cfg.b2) * g * g
                denom = torch.sqrt(v / bc2) + cfg.eps
                mu["v"].copy_(v)
            else:
                g2 = g * g
                vr = cfg.b2 * mu["vr"].float() + (1 - cfg.b2) * g2.mean(-1)
                vc = cfg.b2 * mu["vc"].float() + (1 - cfg.b2) * g2.mean(-2)
                vhat = vr[..., None] * vc[..., None, :] / torch.clamp(
                    vr.mean(-1)[..., None, None], min=1e-30)
                denom = torch.sqrt(vhat / bc2) + cfg.eps
                mu["vr"].copy_(vr)
                mu["vc"].copy_(vc)
            mu["m"].copy_(m)
            upd = (m / bc1) / denom + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
        return params, state, {"grad_norm": gnorm, "lr": lr}
