"""Monte-Carlo predictive evaluation (port of qbn_tpu/evaluation/mc.py)
of converted models (mode 'int', the default) and of float models (mode
'float'), for the four methods. INT:

* Bayes-by-backprop: per batch ONE launch of the posterior-draw kernel
  draws S int8 weight samples of every stochastic layer (`PosteriorDraw`,
  the draw's one owner, packed once an `evaluate`), and ONE forward in
  the merged layout computes every sample;
* MC-Dropout: ONE forward of the deterministic weights, S masked samples
  of activations from the first dropout site on (qbn_tpu vmaps the
  forward over S keys; its convs then fold the samples into the batch,
  the port's keep them on the conv kernel's sample axis);
* pointwise: one forward;
* SGHMC ensembles: one forward per member of a stacked state
  (evaluation/ensemble.py).

Float (qbn_tpu's vmap over S keys, as S eval forwards): Bayes-by-backprop
draws every layer's weights anew for each sample (w + softplus(std) *
eps, `ops/stochastic.sample_weights`, from a noise source);
MC-Dropout draws each site's mask anew for each sample; pointwise runs
once; an ensemble runs one forward per member.

`mc_predict` gives the outputs with the sample axis in front, `aggregate`
the predictive (classification: the mean of the probabilities;
regression: E[mu] and Var[mu] (ddof=1) + E[var]), folded into the metric
state. `evaluate` is the entry point and dispatches on the model's
`method` (models/factory.py). For the harness, `evaluate_with_loader`
evaluates one split with its own generator (qbn_tpu's per-split key) and
returns its metrics, and `evaluate_distortion_sweep` the 15 distorted
test sets, made on the device from one upload of the clean test set.

With a mesh (parallel/mesh.py), each takes the sample-sharded evaluation
of parallel/sharded.py when the samples divide over the mesh's devices
and exceed 1 (qbn_tpu's gate): every rank computes its share of the
samples, and every rank ends with the one-process result.

Spans (profiling.span): each batch of `evaluate` is `mc.batch`, with
`mc.upload`, `mc.draw` and `mc.forward` (in `mc_predict`), `mc.aggregate`
(the predictive and the metric update) and `mc.sync` inside.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import itertools
import operator
import time
import zlib
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from qbn_tpu_torch.convert import to_device
from qbn_tpu_torch.data import datasets as D
from qbn_tpu_torch.data.distortions import (
    DISTORTIONS, LEVELS, apply_spec, gather_spec)
from qbn_tpu_torch.evaluation.ensemble import member, members
from qbn_tpu_torch.models.architectures import ResNet
from qbn_tpu_torch.ops.sample_weights import (
    QPARAM_KEYS, draw_int8, draw_layers, pack_layers, unpack)
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.profiling import span
from qbn_tpu_torch.training import metrics as M
from qbn_tpu_torch.utils import full_float32, resolve_device

_PACKED = ("w", "std", "qtab", "meta", "tile_layer")


def presample_plan(state):
    """Stochastic quantised blocks of a state: [(path, w_lo, w_hi)], path
    the keys of the block's 'q' entry under 'qconst'. None if there are
    none."""
    qconst = state.get("qconst")
    if qconst is None:
        return None
    plan = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        if "w_codes" in node and "is_stoch" in node:
            if int(node["is_stoch"]) == 1:
                plan.append((path, int(node["w_lo"]), int(node["w_hi"])))
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(qconst, ())
    return plan or None


class PosteriorDraw(nn.Module):
    """S int8 posterior samples of every stochastic quantised block of
    `state`, packed once: the plan, the pack's tensors as buffers (w, std,
    qtab, meta, tile_layer) and its layout (shapes, dst, samples, total,
    tiles), which `draw_layers` and `unpack` read off the module as off a
    LayerPack. Build it on the device the state is on."""

    def __init__(self, state, samples: int):
        super().__init__()
        self.plan = presample_plan(state)
        if self.plan is None:
            raise ValueError("the state has no stochastic quantised blocks")
        pack = pack_layers(self.inputs(state), samples)
        for f in _PACKED:
            self.register_buffer(f, getattr(pack, f))
        self.shapes, self.dst, self.samples = pack.shapes, pack.dst, samples
        self.total, self.tiles, self.frozen = pack.total, pack.tiles, False

    def inputs(self, state):
        """The draw's inputs of each plan entry, in plan order, read from
        `state`: [(w_codes, std_codes, qparams, w_lo, w_hi)]."""
        out = []
        for path, w_lo, w_hi in self.plan:
            node = functools.reduce(operator.getitem, path, state["qconst"])
            out.append((node["w_codes"], node["std_codes"],
                        {k: node[k] for k in QPARAM_KEYS}, w_lo, w_hi))
        return out

    def tree(self, codes):
        """The 'sampled' collection of codes in plan order: each entry's
        codes as a 'w' leaf under the block's path (its 'q' key dropped)."""
        out = {}
        for (path, _lo, _hi), c in zip(self.plan, codes):
            cursor = out
            for k in path[:-1]:
                cursor = cursor.setdefault(k, {})
            cursor["w"] = c
        return out

    def forward(self, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None,
                key: Optional[torch.Tensor] = None):
        """The 'sampled' tree: a 'w' leaf of shape (S, *w_codes.shape)
        int8 beside each block's 'q' entry, drawn from the seed and offset
        `key` (an int64 tensor of 2), else from `generator`; noise
        (testing): one (S, *w_codes.shape) float32 tensor per plan entry.
        Frozen, the bank, whatever the source."""
        if self.frozen:
            return self.tree(unpack(self, self.bank))
        return self.tree(draw_layers(self, generator, noise, key))

    def freeze(self, key: torch.Tensor):
        """Draw once from `key` and hold the flat codes as the buffer
        `bank` in place of the pack: every later call returns them."""
        bank = draw_int8(*(getattr(self, f) for f in _PACKED),
                         key.to(self.w.device), None, self.total)
        for f in _PACKED:
            delattr(self, f)
        self.register_buffer("bank", bank)
        self.frozen = True


def _forward(model, x, variables, masks=None, up_to=None):
    """One int-mode forward of any of the architectures."""
    if isinstance(model, ResNet):
        return model(x, variables, up_to=up_to, masks=masks)
    if up_to is not None:
        raise ValueError("up_to cuts exist on the ResNet only")
    return model(x, variables, mode="int", masks=masks)


def _each(out, fn):
    """fn on an output, or on each of a regression model's (mu, var)."""
    return tuple(map(fn, out)) if isinstance(out, tuple) else fn(out)


def mc_predict(model, state, x, *, samples: int, draw=None,
               generator: Optional[torch.Generator] = None,
               presampled=None, up_to: Optional[str] = None,
               ensemble: bool = False, masks=None, mode: str = "int",
               noise=None):
    """All-samples predictive outputs with the sample axis in front:
    (S, B, classes), or for regression (mu, var), (S, B, out) each; or
    the codes at an `up_to` cut (a list of the members' with `ensemble`).

    * ensemble: `state` stacked on a member axis of `samples` members;
    * Bayes-by-backprop (a stochastic model): weights drawn here from
      `generator` by `draw` (a PosteriorDraw of `samples` samples; built
      here if None), or given as `presampled`; one merged-layout forward;
    * MC-Dropout (a model with dropout sites): one forward, its masks from
      `masks` (a mask source, ops/stochastic.py) or drawn from
      `generator`;
    * pointwise: one forward, its output repeated S times (qbn_tpu runs
      the same deterministic forward under S keys).

    mode 'float' (a float state) or 'qat' (a QAT state, its fake-quant
    eval forward): `float_predict`, with `noise` (BBB) and `masks`
    (MC-Dropout) as its sources, else drawn from `generator`."""
    if mode in ("float", "qat"):
        with span("mc.forward"):
            return float_predict(model, state, x, samples=samples,
                                 generator=generator, ensemble=ensemble,
                                 noise=noise, masks=masks, mode=mode)
    if mode != "int":
        raise ValueError(f"unknown mode '{mode}'")
    if ensemble:
        if members(state) != samples:
            raise ValueError(f"an ensemble of {members(state)} members "
                             f"evaluated as {samples} samples")
        with span("mc.forward"):
            outs = [_forward(model, x, member(state, m), up_to=up_to)
                    for m in range(samples)]
        if up_to is not None:
            return outs
        return _stack(outs)
    if model.stochastic:
        if presampled is None:
            with span("mc.draw"):
                presampled = (draw or PosteriorDraw(state, samples))(
                    generator)
        with span("mc.forward"):
            out = _forward(model, x, {**state, "sampled": presampled},
                           up_to=up_to)
        if up_to is not None:
            return out
        return _each(out, lambda o: o.transpose(0, 1))   # (B, S) -> (S, B)
    with span("mc.forward"):
        if model.dropout_p > 0:
            return _forward(model, x, state, up_to=up_to,
                            masks=masks or BernoulliMasks(generator,
                                                          samples))
        out = _forward(model, x, state, up_to=up_to)
    if up_to is not None:
        return out
    return _each(out, lambda o: o.unsqueeze(0).expand(samples, *o.shape))


def _stack(outs):
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def float_predict(model, state, x, *, samples: int,
                  generator: Optional[torch.Generator] = None,
                  ensemble: bool = False, noise=None, masks=None,
                  mode: str = "float"):
    """Float MC predictive outputs with the sample axis in front: (S, B,
    classes), or (mu, var), (S, B, out) each. One eval forward (train
    False: batch norm's running statistics, one weight draw or mask per
    layer) per sample: per member with `ensemble`; for a stochastic model
    or one with dropout sites, S forwards drawing anew from `noise` and
    `masks` (sources of ops/stochastic.py; by default from `generator`),
    sample by sample; else one forward repeated S times. mode 'qat':
    the same with the fake-quantised eval forward."""
    def forward(variables):
        return model(x, variables, mode=mode, train=False, noise=noise,
                     masks=masks)

    if noise is None:
        noise = GeneratorNoise(generator)
    if masks is None:
        masks = BernoulliMasks(generator, 1)
    if ensemble:
        if members(state) != samples:
            raise ValueError(f"an ensemble of {members(state)} members "
                             f"evaluated as {samples} samples")
        return _stack([forward(member(state, m)) for m in range(samples)])
    if model.stochastic or model.dropout_p > 0:
        return _stack([forward(state) for _ in range(samples)])
    return _each(forward(state),
                 lambda o: o.unsqueeze(0).expand(samples, *o.shape))


def aggregate(outs, task: str = "classification"):
    """The predictive over the sample axis: classification, the mean of
    the probabilities; regression, (E[mu], Var[mu] (ddof=1, as torch.var)
    + E[var]), the variance term dropped at one sample. The reductions
    run over contiguous (S, B, ...) memory, whatever layout the forward
    left (the merged layout's outputs are views of (B, S, ...) memory),
    so that the result depends on the outputs' values alone: the samples
    joined from chunks or ranks aggregate bitwise as one forward's."""
    if task == "classification":
        return torch.mean(outs.contiguous(), dim=0)
    mu, var = (o.contiguous() for o in outs)
    mean = torch.mean(mu, dim=0)
    total = torch.mean(var, dim=0)
    if mu.shape[0] > 1:
        total = torch.var(mu, dim=0, correction=1) + total
    return mean, total


def evaluate(model, state, batches: Iterable, samples: int,
             generator: Optional[torch.Generator] = None, device="cuda",
             mode: str = "int", mesh=None):
    """MC evaluation over (x, y) batches of a model from models/factory.py
    (its `method` and `task` choose the path), INT8 on a converted state
    (mode 'int') or float32 on a float one (mode 'float'): x (B, ...)
    float32 inputs, y (B,) labels or regression targets (numpy or torch).
    `generator` draws the posterior weights (BBB) or the dropout masks
    (MC-Dropout; a generator on the card draws them there); an SGHMC
    state holds `samples` stacked members.

    mesh: a parallel.mesh.Mesh; with samples % mesh.size == 0 and
    samples > 1 the sample axis is sharded over it (device: the mesh's).

    Returns (metric_state, [aggregated output per batch: (B, classes)
    probabilities, or (mean, var)], [seconds per batch, host clock
    around work that ends in a device synchronise])."""
    device = resolve_device(device)
    predict = mc_predict
    if mesh is not None and samples % mesh.size == 0 and samples > 1:
        from qbn_tpu_torch.parallel.sharded import sharded_mc_predict

        def predict(model, state, x, **kw):
            return sharded_mc_predict(model, state, x, mesh, **kw)
    state = to_device(state, device)
    method, regression = model.method, model.task == "regression"
    draw = (PosteriorDraw(state, samples)
            if method == "bbb" and mode == "int" else None)
    masks = (BernoulliMasks(generator, samples if mode == "int" else 1)
             if method == "mcdropout" else None)
    metric_state = (M.reg_metrics_init(device=device) if regression
                    else M.cls_metrics_init(device=device))
    outputs: List = []
    seconds: List[float] = []
    with torch.no_grad(), (full_float32() if mode == "float"
                           else contextlib.nullcontext()):
        for x, y in batches:
            with span("mc.batch"):
                t0 = time.perf_counter()
                with span("mc.upload"):
                    x = torch.as_tensor(x, dtype=torch.float32,
                                        device=device).contiguous()
                    y = torch.as_tensor(y, device=device,
                                        dtype=torch.float32 if regression
                                        else torch.int64)
                outs = predict(model, state, x, samples=samples, draw=draw,
                               generator=generator, masks=masks,
                               ensemble=method == "sgld", mode=mode)
                with span("mc.aggregate"):
                    agg = aggregate(outs, model.task)
                    if regression:
                        metric_state = M.reg_metrics_update(metric_state,
                                                            *agg, y)
                    else:
                        metric_state = M.cls_metrics_update(metric_state,
                                                            agg, y)
                with span("mc.sync"):
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                seconds.append(time.perf_counter() - t0)
                outputs.append(agg)
    return metric_state, outputs, seconds


def split_generator(cfg, salt: str, seed: int = 0, device="cuda"):
    """The generator of one split's posterior draws and masks, on
    `device`: qbn_tpu keys a split from PRNGKey(cfg.seed + 1234) with
    crc32(salt) folded in, and each batch with seed * 1000003 + its
    index; here one generator per (cfg.seed, seed, salt) serves the
    split's batches in order. The seed is a 64-bit digest of the three,
    every bit depending on each: the CPU's generator keeps only the low
    32 bits of its seed."""
    crc = zlib.crc32(salt.encode()) & 0x7FFFFFFF
    digest = hashlib.blake2b(f"{cfg.seed + 1234}/{seed}/{crc}".encode(),
                             digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest, "little"))


def evaluate_with_loader(loader, model, state, cfg, mode: str,
                         samples: Optional[int] = None, seed: int = 0,
                         collect_outputs: bool = True, salt: str = "",
                         device="cuda", mesh=None):
    """Monte-Carlo evaluation of one split (qbn_tpu's
    `evaluate_with_loader`): its (x, y) batches from `loader` (with
    cfg.debug, the first only), `evaluate` with the split's generator
    (`split_generator(cfg, salt, seed)`), cfg.samples samples unless
    given, sample-sharded over `mesh` where `evaluate` takes it. Returns
    (error, ece, entropy, nll, outputs, targets,
    example-samples per second): for regression error is the RMSE and
    ece and entropy are 0; outputs and targets are numpy (the (N,
    classes) probabilities, or (mean, var)), None without
    collect_outputs."""
    device = resolve_device(device)
    samples = cfg.samples if samples is None else samples
    gen = split_generator(cfg, salt, seed, device)
    targets: List = []

    def batches():
        for x, y in (itertools.islice(loader, 1) if cfg.debug else loader):
            if collect_outputs:
                targets.append(np.asarray(torch.as_tensor(y).cpu()))
            yield x, y

    t0 = time.perf_counter()
    metric_state, outs, _sec = evaluate(model, state, batches(), samples,
                                        gen, device, mode, mesh)
    dt = max(time.perf_counter() - t0, 1e-9)
    sps = float(metric_state["count"]) * samples / dt
    if model.task == "classification":
        m = {k: float(v) for k, v in M.cls_metrics_compute(
            metric_state).items()}
        error, ece, entropy = m["error"], m["ece"], m["entropy"]
    else:
        m = {k: float(v) for k, v in M.reg_metrics_compute(
            metric_state).items()}
        error, ece, entropy = m["rmse"], 0.0, 0.0
    out = tgt = None
    if collect_outputs and outs:
        if model.task == "classification":
            out = torch.cat(outs).cpu().numpy()
        else:
            out = tuple(torch.cat(o).cpu().numpy() for o in zip(*outs))
        tgt = np.concatenate(targets)
    return error, ece, entropy, m["nll"], out, tgt, sps


def evaluate_distortion_sweep(model, state, cfg, mode: str,
                              samples: Optional[int] = None, seed: int = 0,
                              device="cuda", mesh=None):
    """The 3 x 5 distortion sweep of an image dataset's test set (qbn_tpu's
    device sweep): the clean images uploaded once, each cell made on the
    device (`apply_spec`), normalised, cut into cfg.batch_size batches in
    order and evaluated with the cell's generator (salt
    f"{distortion}{level}"), as qbn_tpu's loader path would evaluate
    `get_test_loader(cfg, distortion, level)`. With cfg.debug, the first
    cell only; sample-sharded over `mesh` as `evaluate` takes it.
    Returns [(distortion, level, error, ece, entropy, nll)]."""
    device = resolve_device(device)
    x, y = D.load_images(cfg.dataset, cfg.data, train=False)
    xd, yd = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    norm = "cifar" if cfg.dataset == "cifar" else None
    bsz = cfg.batch_size
    cells = [(d, lv) for d in DISTORTIONS for lv in range(LEVELS)]
    out = []
    for d, lv in cells[:1] if cfg.debug else cells:
        xc = D.normalize(apply_spec(xd, gather_spec(d, lv, *x.shape[1:3])),
                         norm)
        batches = [(xc[i:i + bsz], yd[i:i + bsz])
                   for i in range(0, len(xc), bsz)]
        error, ece, entropy, nll, _o, _t, _sps = evaluate_with_loader(
            batches, model, state, cfg, mode, samples, seed,
            collect_outputs=False, salt=f"{d}{lv}", device=device,
            mesh=mesh)
        out.append((d, lv, error, ece, entropy, nll))
    return out
