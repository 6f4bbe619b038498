"""Adaptive stochastic-gradient HMC in functional form (port of
qbn_tpu/training/sghmc.py, scale-adapted SGHMC, Chen et al. 2014).

`sghmc(...)` is a GradientTransformation like the port's `adam` and `sgd`
(training/optim.py): `init(params) -> state`, `update(grads, state,
params) -> (updates, new_state)`, every state leaf a tensor on the
params' device:

  * per parameter, the preconditioner state (tau, g, v_hat), adapted
    during burn-in;
  * the momentum, resampled every `resample_momentum_every` steps from
    N(0, lr^2 V^-1/2);
  * per parameter tensor, the Gaussian prior's precision, resampled every
    `resample_prior_every` steps from Gamma(alpha0 + n/2) / (beta0 +
    |p|^2/2);
  * friction base_c and injected noise of variance
    2 lr^2 V^-1/2 base_c - lr^4, floored at 1e-16;
  * the momentum's NaN and inf entries set to 0.

The burn-in, resampling and scrub conditions are torch.where on the
device step count, as qbn_tpu's jnp.where: no host round trip, and a
step that the trainer drops (its non-finite-loss skip) keeps the old
count with the rest of the state. The update is the momentum (p += v).

Every update draws, per parameter tensor, a standard normal of its shape
for the momentum, another for the injected noise, and one standard
Gamma(alpha0 + n/2) scalar, whether or not this step uses them, as
qbn_tpu draws them. They come from a draw source: `GeneratorDraws` (a
torch.Generator; by default one on the params' device seeded with
`seed`, made at `init`) or `QueueDraws`, the explicit-draws entry, which
hands out given arrays in call order (the tests feed it the draws of a
qbn_tpu run).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch

from qbn_tpu_torch.training.optim import (
    GradientTransformation, tree_map, tree_unflatten)
from qbn_tpu_torch.utils import tree_leaves

EPS = 1e-6


class GeneratorDraws:
    """One update's draws from a torch.Generator, on the generator's
    device: the normals of every tensor in one call and the Gamma draws
    in another, split per tensor. `draws(shapes, alphas, device)` ->
    [(momentum normal, noise normal, Gamma scalar)] per tensor."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, shapes, alphas, device):
        g = self.generator
        sizes = [int(np.prod(s)) for s in shapes]
        normals = torch.randn(2 * sum(sizes), generator=g,
                              device=g.device).to(device)
        gammas = torch._standard_gamma(
            torch.tensor(alphas, dtype=torch.float32, device=g.device),
            generator=g).to(device)
        out, at = [], 0
        for i, (shape, n) in enumerate(zip(shapes, sizes)):
            mom = normals[at:at + n].reshape(shape)
            noise = normals[at + n:at + 2 * n].reshape(shape)
            out.append((mom, noise, gammas[i]))
            at += 2 * n
        return out


class QueueDraws:
    """The given draws, one update's list per call: [(momentum normal,
    noise normal, Gamma scalar)] per tensor in the params' leaf order
    (numpy or torch); raises on a shape that does not match or when the
    queue runs dry."""

    def __init__(self, steps: Iterable):
        self.queue = list(steps)

    def __call__(self, shapes, alphas, device):
        if not self.queue:
            raise RuntimeError("SGHMC draw queue is empty")
        step = self.queue.pop(0)
        if len(step) != len(shapes):
            raise ValueError(f"{len(step)} queued draws for {len(shapes)} "
                             "tensors")
        out = []
        for (mom, noise, gamma), shape in zip(step, shapes):
            mom, noise, gamma = (torch.as_tensor(np.asarray(a),
                                                 dtype=torch.float32,
                                                 device=device)
                                 for a in (mom, noise, gamma))
            if tuple(mom.shape) != tuple(shape) or \
                    tuple(noise.shape) != tuple(shape):
                raise ValueError(f"queued normals of shape "
                                 f"{tuple(mom.shape)}, the tensor is "
                                 f"{tuple(shape)}")
            out.append((mom, noise, gamma.reshape(())))
        return out


def sghmc(learning_rate: Union[float, Callable], burnin_steps: int,
          resample_momentum_every: int, resample_prior_every: int,
          base_c: float = 0.05, gauss_sig: float = 0.1,
          alpha0: float = 10.0, beta0: float = 10.0, seed: int = 0,
          draws: Optional[Callable] = None) -> GradientTransformation:
    """The SGHMC transform (qbn_tpu's `sghmc`). learning_rate: a float or
    a schedule of the int32 update count. draws: a draw source (see the
    module docstring); None: GeneratorDraws of a generator on the params'
    device seeded with `seed`, made at init."""
    init_wd = 0.0 if gauss_sig == 0 else 1.0 / (gauss_sig ** 2)
    if init_wd <= 0.0:
        raise ValueError(f"Invalid weight_decay value: {init_wd}")
    if base_c < 0:
        raise ValueError(f"Invalid friction term: {base_c}")
    source = {"draws": draws}

    def lr_at(count):
        if callable(learning_rate):
            return learning_rate(count).to(torch.float32)
        return torch.tensor(learning_rate, dtype=torch.float32,
                            device=count.device)

    def init(params):
        leaves = list(tree_leaves(params))
        device = leaves[0].device
        if source["draws"] is None:
            source["draws"] = GeneratorDraws(
                torch.Generator(device=device).manual_seed(seed))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "tau": tree_map(torch.ones_like, params),
            "g": tree_map(torch.ones_like, params),
            "v_hat": tree_map(torch.ones_like, params),
            "momentum": tree_map(torch.zeros_like, params),
            "weight_decay": tree_map(
                lambda p: torch.tensor(init_wd, dtype=torch.float32,
                                       device=p.device), params),
        }

    def update(grads, state, params):
        count = state["count"]
        lr = lr_at(count)
        burn_in = count < burnin_steps
        do_mom = (count % resample_momentum_every) == 0
        do_prior = (count % resample_prior_every) == 0
        p_leaves = list(tree_leaves(params))
        drawn = source["draws"]([p.shape for p in p_leaves],
                                [alpha0 + p.numel() / 2.0 for p in p_leaves],
                                p_leaves[0].device)

        def leaf(p, grad, tau, g, v_hat, mom, wd, draw):
            mom_eps, noise_eps, gamma = draw
            # prior precision resample: Gamma(alpha0 + n/2, beta) / beta
            beta = beta0 + 0.5 * torch.sum(p * p)
            wd = torch.where(do_prior, gamma / (beta + EPS), wd)

            d_p = grad + wd * p

            # burn-in preconditioner adaptation
            tau_n = tau + (-tau * g * g / (v_hat + EPS) + 1.0)
            tau_inv = 1.0 / (tau_n + EPS)
            g_n = g + (-tau_inv * g + tau_inv * d_p)
            v_hat_n = v_hat + (-tau_inv * v_hat + tau_inv * d_p * d_p)
            tau = torch.where(burn_in, tau_n, tau)
            g = torch.where(burn_in, g_n, g)
            v_hat = torch.where(burn_in, v_hat_n, v_hat)

            v_inv_sqrt = 1.0 / (torch.sqrt(v_hat) + EPS)

            mom = torch.where(do_mom,
                              mom_eps * torch.sqrt(lr * lr * v_inv_sqrt),
                              mom)

            noise_var = 2.0 * lr * lr * v_inv_sqrt * base_c - lr ** 4
            noise_std = torch.sqrt(torch.clamp(noise_var, min=1e-16))
            noise = noise_eps * noise_std

            mom = mom + (-(lr * lr) * v_inv_sqrt * d_p - base_c * mom
                         + noise)
            mom = torch.where(torch.isfinite(mom), mom,
                              torch.zeros_like(mom))     # NaN/inf scrub
            return mom, tau, g, v_hat, wd

        names = ("momentum", "tau", "g", "v_hat", "weight_decay")
        columns = zip(*(leaf(*args) for args in zip(
            p_leaves, *(tree_leaves(t) for t in (
                grads, state["tau"], state["g"], state["v_hat"],
                state["momentum"], state["weight_decay"])), drawn)))
        new = {name: tree_unflatten(params, iter(col))
               for name, col in zip(names, columns)}
        new["count"] = count + 1
        return new["momentum"], new

    return GradientTransformation(init, update)
