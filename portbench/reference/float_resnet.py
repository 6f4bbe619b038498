"""Float32 training of the Bayes-by-backprop CIFAR ResNet-18, written down
plainly (the reference's BBB layers, models_bbb.py, trained by local
reparametrisation):

* each conv and the dense head hold a mean `kernel` and a `std` whose
  softplus is the posterior's sigma; in training a layer outputs
  x * w + sqrt(1e-8 + x^2 * sigma^2) * eps, eps a standard normal of the
  output's shape, drawn layer by layer in forward order from one
  generator;
* every conv is followed by batch norm over (B, H, W) with the batch's
  biased variance; the running statistics move by momentum 0.1 toward the
  batch mean and the unbiased variance;
* the loss (the campaign's 'batch' scaling) is the mean NLL of the
  softmax plus gamma * KL / (batch * batches per epoch), the KL of each
  layer's Gaussian posterior against N(0, sigma_prior^2), summed;
* Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) at the cosine
  schedule's rate, which holds through the first epoch.

NHWC activations and HWIO kernels, as the state's leaves are stored; the
convolutions run in NCHW. Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.int_resnet import blocks

VAR_EPS, BN_EPS, BN_MOMENTUM = 1e-8, 1e-5, 0.1
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def conv_layers(arch):
    """[(path, kh, cin, cout, stride, pad)] of every conv in forward
    order (the order of their noise draws)."""
    w = arch["widths"]
    out = [(("stem",), 3, arch["input"][2], w[0], 1, 1)]
    cin = w[0]
    for name, stride, sc in blocks(arch):
        planes = w[int(name.split("_")[0][5:])]
        out.append(((name, "conv_bn_relu"), 3, cin, planes, stride, 1))
        out.append(((name, "conv_bn"), 3, planes, planes, 1, 1))
        if sc:
            out.append(((name, "shortcut"), 1, cin, planes, stride, 0))
        cin = planes
    return out


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_state(arch, init, generator, device):
    """(params, batch_stats): every kernel U(-b, b) from ONE draw of the
    generator (b = init['kernel_bound']), every std the constant of its
    kind, batch norm's scale 1 and shift 0, running mean 0 and var 1."""
    convs = conv_layers(arch)
    fc = (arch["widths"][-1], arch["classes"])
    shapes = [(k, k, cin, cout) for _p, k, cin, cout, _s, _d in convs] + [fc]
    total = sum(math.prod(s) for s in shapes)
    b = float(init["kernel_bound"])
    flat = torch.rand(total, generator=generator, device=device) * (2 * b) - b
    params, stats, at = {}, {}, 0
    for (path, *_r), shape in zip(convs, shapes):
        n = math.prod(shape)
        cout = shape[-1]
        _set(params, path, {
            "kernel": flat[at:at + n].reshape(shape).clone(),
            "std": torch.full(shape, float(init["std_conv"]), device=device),
            "bn_scale": torch.ones(cout, device=device),
            "bn_bias": torch.zeros(cout, device=device)})
        _set(stats, path, {"mean": torch.zeros(cout, device=device),
                           "var": torch.ones(cout, device=device)})
        at += n
    params["fc"] = {
        "kernel": flat[at:].reshape(fc).clone(),
        "std": torch.full(fc, float(init["std_dense"]), device=device)}
    return params, stats


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def kl_gauss(mu, sigma, sigma_prior: float):
    sp = torch.full_like(sigma, sigma_prior)
    return 0.5 * torch.sum(2.0 * torch.log(sp / sigma) - 1.0
                           + (sigma / sp) ** 2 + (mu / sp) ** 2)


def _conv(x, w, stride, pad):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def forward(params, stats, x, noise, arch, sigma_prior):
    """(probs, kl, new running statistics) of one training forward;
    noise(shape) draws the next standard normals."""
    kls, new_stats = [], {}

    def layer(path, h, stride, pad, relu):
        p = _get(params, path)
        sp = softplus(p["std"])
        kls.append(kl_gauss(p["kernel"], sp, sigma_prior))
        mean = _conv(h, p["kernel"], stride, pad)
        var = _conv(h * h, sp * sp, stride, pad)
        y = mean + torch.sqrt(VAR_EPS + var) * noise(mean.shape)
        m = torch.mean(y, dim=(0, 1, 2))
        v = torch.var(y, dim=(0, 1, 2), correction=0)
        n = y.shape[0] * y.shape[1] * y.shape[2]
        st = _get(stats, path)
        _set(new_stats, path, {
            "mean": (1 - BN_MOMENTUM) * st["mean"] + BN_MOMENTUM * m.detach(),
            "var": (1 - BN_MOMENTUM) * st["var"]
            + BN_MOMENTUM * (v.detach() * n / (n - 1))})
        y = (y - m) * torch.rsqrt(v + BN_EPS) * p["bn_scale"] + p["bn_bias"]
        return torch.relu(y) if relu else y

    h = layer(("stem",), x, 1, 1, True)
    for name, stride, sc in blocks(arch):
        o = layer((name, "conv_bn_relu"), h, stride, 1, True)
        o = layer((name, "conv_bn"), o, 1, 1, False)
        r = layer((name, "shortcut"), h, stride, 0, False) if sc else h
        h = torch.relu(o + r)
    h = torch.mean(h, dim=(1, 2))
    p = params["fc"]
    sp = softplus(p["std"])
    kls.append(kl_gauss(p["kernel"], sp, sigma_prior))
    mean = h @ p["kernel"]
    var = (h * h) @ (sp * sp)
    logits = mean + torch.sqrt(VAR_EPS + var) * noise(mean.shape)
    kl = sum(kls)
    return torch.softmax(logits, dim=-1), kl, new_stats


def loss_fn(probs, y, kl, gamma: float, n_batches: int):
    logp = torch.log(probs + 1e-8)
    nll = -torch.mean(torch.take_along_dim(logp, y[:, None], dim=1))
    return nll + gamma * kl / (y.shape[0] * n_batches)


def leaves(tree, path=()):
    """[(path, tensor)] in the tree's order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaves(v, path + (k,))
        else:
            out.append((path + (k,), v))
    return out


def train(params, stats, batches, noise, arch, hp, n_batches: int,
          tf32: bool = False, adam=None):
    """Follow len(batches) Adam steps from (params, stats) and Adam's state
    `adam` ({"mu": {path: tensor}, "nu": {...}, "count": steps taken};
    None: a fresh one). Returns {"loss": [per step], "grad1": {path: first
    gradient}, "stats1": {path: running statistics after the first step},
    "params": {path: params after the steps}}."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        named = leaves(params)
        ps = [t.detach().clone().requires_grad_() for _p, t in named]
        if adam is None:
            mu = [torch.zeros_like(t) for t in ps]
            nu = [torch.zeros_like(t) for t in ps]
            count = 0
        else:
            mu = [adam["mu"][path].clone() for path, _t in named]
            nu = [adam["nu"][path].clone() for path, _t in named]
            count = int(adam["count"])
        out = {"loss": []}
        for step, (x, y) in enumerate(batches, start=1):
            tree = {}
            for (path, _t), p in zip(named, ps):
                _set(tree, path, p)
            probs, kl, stats = forward(tree, stats, x, noise, arch,
                                       hp["sigma_prior"])
            loss = loss_fn(probs, y, kl, hp["gamma"], n_batches)
            grads = torch.autograd.grad(loss, ps)
            out["loss"].append(float(loss.detach()))
            if step == 1:
                out["grad1"] = {path: g.detach().clone()
                                for (path, _t), g in zip(named, grads)}
                out["stats1"] = dict(leaves(stats))
            with torch.no_grad():
                bc1 = 1 - B1 ** (count + step)
                bc2 = 1 - B2 ** (count + step)
                new = []
                for p, g, m, v in zip(ps, grads, mu, nu):
                    m.mul_(B1).add_((1 - B1) * g)
                    v.mul_(B2).add_((1 - B2) * g * g)
                    upd = -hp["learning_rate"] * (
                        (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
                    new.append((p + upd).detach().requires_grad_())
                ps = new
        out["params"] = {path: p.detach() for (path, _t), p in zip(named, ps)}
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
