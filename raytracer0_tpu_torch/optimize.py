"""Inverse rendering: gradient-based scene-parameter optimization
(port of raytracer0_tpu/optimize.py).

Fit selected scene parameters so the render matches a target image: a
dict of *selected* leaves (a mask keeps non-optimized rows frozen), an L2
loss on the linear-radiance accumulator over a fixed pass budget (fixed
RNG, so the loss is deterministic and its gradient exact for the realized
estimator), and Adam.  On a CUDA device each step renders through K1 and
back-propagates through its adjoint K2 (`ops/megakernel.py`); on the CPU
through the plain integrator and its autograd.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional

import torch

from raytracer0_tpu_torch.render.renderer import sample_radiance


def render_linear(scene, cfg, camera, height, width, passes=1):
    """Mean linear radiance f32[H, W, 3] over `passes` fixed-RNG passes (the
    accumulator the display pass divides; tonemapping is excluded from the
    loss so gradients see linear light)."""
    if cfg.use_restir:
        raise NotImplementedError(
            "render_linear through the ReSTIR reservoir ring is not ported "
            "yet: ROADMAP queue 1 item 11")
    total = torch.zeros((height, width, 3), dtype=torch.float32,
                        device=scene.device)
    for p in range(passes):
        total = total + sample_radiance(scene, cfg, camera, height, width, p)
    return total / passes


def make_loss(cfg, camera, target, param_names: Iterable[str], height, width,
              passes=1):
    """L2 loss over the selected scene leaves.

    `param_names`: Scene field names (e.g. ("emission", "color", "pos",
    "joker")).  Returns (names, loss_fn) where `loss_fn(params, scene)`
    renders `scene` with the tensors of the dict `params` in place of those
    fields."""
    names = tuple(param_names)

    def loss_fn(params: Mapping[str, torch.Tensor], scene):
        img = render_linear(scene.replace(**dict(params)), cfg, camera,
                            height, width, passes)
        return torch.mean((img - target) ** 2)

    return names, loss_fn


def fit(scene, cfg, camera, target, param_names, *, steps=100,
        learning_rate=2e-2, height=None, width=None, passes=1,
        optimizer: Optional[Callable] = None, param_mask=None,
        callback=None):
    """Fit `param_names` of `scene` to a target image f32[H, W, 3].

    Returns (optimized scene, list of losses, one per step, each taken
    before that step's update).  `param_mask`, when given, maps name -> 0/1
    tensor broadcastable to that leaf (e.g. optimize only the light rows'
    emission); the gradient is multiplied by it before the update.
    `optimizer` maps the list of parameter tensors to a
    `torch.optim.Optimizer`; the default is `torch.optim.Adam` at
    `learning_rate` with the defaults of `optax.adam` (betas 0.9 and 0.999,
    eps 1e-8).  After every update emission and color are floored at 0."""
    height = height or target.shape[0]
    width = width or target.shape[1]
    names, loss_fn = make_loss(cfg, camera, target, param_names, height,
                               width, passes)
    params = {n: getattr(scene, n).detach().clone().requires_grad_(True)
              for n in names}
    mask = {n: torch.as_tensor((param_mask or {}).get(n, 1.0),
                               dtype=torch.float32, device=scene.device)
            for n in names}
    ordered = [params[n] for n in names]
    opt = (optimizer(ordered) if optimizer is not None else
           torch.optim.Adam(ordered, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8))

    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(params, scene)
        loss.backward()
        with torch.no_grad():
            for n in names:
                if params[n].grad is not None:
                    params[n].grad.mul_(mask[n])
        opt.step()
        with torch.no_grad():
            # physical floors: radiance and albedo never negative
            for n in ("emission", "color"):
                if n in params:
                    params[n].clamp_(min=0.0)
        losses.append(loss.item())
        if callback is not None:
            callback(i, losses[-1], params)
    return scene.replace(**{n: p.detach() for n, p in params.items()}), losses
