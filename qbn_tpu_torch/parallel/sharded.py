"""Mesh-sharded train, validation and MC-evaluation steps (port of
qbn_tpu/parallel/sharded.py).

Training: state replicated, batch sharded over the mesh's first axis. A
rank's step runs its rows (`shard_batch`) under a data group
(training/trainer.py): batch norm's batch statistics and the observers'
extrema are the global batch's, the gradients and the loss are one
all-reduce summed over the ranks and divided by their number, and the
skip of a non-finite step follows the global loss. The noise and masks
are the one-process step's: every rank draws the global batch's
per-row noise and masks from the replicated source and keeps its rows
(`ops.stochastic.RowNoise`, `RowMasks`), and takes whole draws (a weight
sample) whole. No DistributedDataParallel: the params are trees, not
module parameters.

MC evaluation: the sample axis sharded over the mesh's last axis, the
batch replicated. Rank i of n evaluates samples [i*S/n, (i+1)*S/n) of
the one-process evaluation's S samples, with the one-process draws of
those samples (`local_outputs`); the per-sample outputs are all-gathered
in rank order along the sample axis and aggregated as in one process
(`evaluation.mc.aggregate` reduces contiguous (S, B, ...) memory, so the
gathered samples aggregate bitwise as one process's). The sharded
evaluation is thus the one-process evaluation, seeded or with the draws
given. A deterministic model (pointwise) runs its one forward on every
rank, as one process runs it once for all its samples.

What that costs: the forwards are sharded, the seeded draws are not.
The one-process draws come from one replicated source in an order that
does not split by sample (the draw kernel's Philox counters run over
each layer's (S, ...) codes; a generator hands out masks and normals in
call order), so every rank makes all S samples' draws and keeps its
share: BBB INT, one draw-kernel launch of all S samples' int8 codes (S
times the weights in device memory, where the share needs S/n); MC-
Dropout, each site's (S, ...) masks; float mode, the draws of the other
ranks' samples too (replayed from the calls of a forward at one row,
ops.stochastic.DrawLog), without their forwards. An ensemble's members
are sliced, and given draws (presampled codes, QueueMasks, QueueNoise)
are skipped at no cost. PERF.md gives the time a rank's share
takes beside that of the same share with its own draws only (chip_smoke
phase parallel). qbn_tpu folds the device index into the key instead,
and so draws S/n samples a device; its draws agree with the one-device
draws at one sample a device only (threefry's split is a fold-in), and
the port keeps them equal at every share.

As in qbn_tpu, the callers gate: the Trainer takes the sharded steps
only when a batch divides over the mesh's devices, and
`evaluation.mc.evaluate` the sharded evaluation only when the samples
do and exceed 1; the other batches and evaluations run the one-process
step on every rank alike.
"""

from __future__ import annotations

from typing import Optional

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.evaluation.ensemble import member
from qbn_tpu_torch.evaluation.mc import (
    PosteriorDraw, _each, _forward, _stack, aggregate, mc_predict)
from qbn_tpu_torch.ops.stochastic import (
    BernoulliMasks, DrawLog, GeneratorNoise, RowMasks, RowNoise,
    SampleMasks)
from qbn_tpu_torch.ops.collectives import all_gather_rows
from qbn_tpu_torch.parallel.mesh import Mesh
from qbn_tpu_torch.training import metrics as M
from qbn_tpu_torch.training.optim import tree_map
from qbn_tpu_torch.training.trainer import make_eval_step, make_train_step


def _row_views(mesh: Mesh, n: int, noise, masks):
    """The sources of a rank holding n rows along the data axis."""
    axis = mesh.axis_names[0]
    i = mesh.axis_index(axis)
    rows, total = slice(i * n, (i + 1) * n), n * mesh.axis_size(axis)
    return (RowNoise(noise, rows, total),
            None if masks is None else RowMasks(masks, rows, total))


def make_sharded_train_step(model, cfg: Config, tx, mode: str,
                            n_batches: int, n_points: int, mesh: Mesh):
    """Data-parallel training step: step(state, metric_state, x, y, noise,
    masks) with x, y this rank's rows (`shard_batch`); state, metric
    state and logs come back replicated (the global batch's)."""
    base = make_train_step(model, cfg, tx, mode, n_batches, n_points,
                           group=mesh.group(mesh.axis_names[0]))

    def step(state, metric_state, x, y, noise, masks=None):
        return base(state, metric_state, x, y,
                    *_row_views(mesh, len(y), noise, masks))

    return step


def make_sharded_eval_step(model, cfg: Config, mode: str,
                           update_observers: bool, mesh: Mesh):
    """Data-parallel (validation) eval step, its inputs as for
    make_sharded_train_step."""
    base = make_eval_step(model, cfg, mode, update_observers,
                          group=mesh.group(mesh.axis_names[0]))

    def step(state, metric_state, x, y, noise, masks=None):
        return base(state, metric_state, x, y,
                    *_row_views(mesh, len(y), noise, masks))

    return step


def sample_share(mesh: Mesh, samples: int) -> slice:
    """This rank's samples of `samples` along the mesh's last axis."""
    axis = mesh.axis_names[-1]
    n = mesh.axis_size(axis)
    if samples % n:
        raise ValueError(f"{samples} samples do not divide over {n} ranks")
    c = samples // n
    i = mesh.axis_index(axis)
    return slice(i * c, (i + 1) * c)


def _float_share(model, state, x, share: slice, samples: int, mode: str,
                 generator, noise, masks, ensemble: bool):
    """The float (or 'qat' eval) outputs of samples `share`, each an eval
    forward with the one-process draws of its sample."""
    def forward(x, variables, noise, masks):
        return model(x, variables, mode=mode, train=False, noise=noise,
                     masks=masks)

    noise = GeneratorNoise(generator) if noise is None else noise
    masks = BernoulliMasks(generator, 1) if masks is None else masks
    if ensemble:
        return _stack([forward(x, member(state, m), noise, masks)
                       for m in range(share.start, share.stop)])
    drawn = DrawLog(1)
    forward(x[:1], state, drawn, drawn.masks)
    outs = []
    for s in range(samples):
        if share.start <= s < share.stop:
            outs.append(forward(x, state, noise, masks))
        else:                  # another rank's sample: its draws dropped
            drawn.replay(noise, masks, len(x), x.device)
    return _stack(outs)


def local_outputs(model, state, x, share: slice, samples: int, *,
                  mode: str = "int", draw=None,
                  generator: Optional[torch.Generator] = None,
                  presampled=None, masks=None, noise=None,
                  ensemble: bool = False):
    """mc_predict's outputs for samples `share` of an S-sample evaluation
    of a stochastic model or an ensemble (sample axis in front), with the
    one-process draws of those samples: one rank's part of the
    sample-sharded evaluation. draw: the PosteriorDraw of all S samples
    (BBB INT; built here if None); presampled: all S samples' codes;
    masks: a source of all S samples' masks (INT) or one sample's
    (float); noise (float): a source of the one-process draws."""
    c = share.stop - share.start
    if mode in ("float", "qat"):
        return _float_share(model, state, x, share, samples, mode,
                            generator, noise, masks, ensemble)
    if mode != "int":
        raise ValueError(f"unknown mode '{mode}'")
    if ensemble:
        return _stack([_forward(model, x, member(state, m))
                       for m in range(share.start, share.stop)])
    if model.stochastic:
        if presampled is None:
            presampled = (draw or PosteriorDraw(state, samples))(generator)
        return mc_predict(model, state, x, samples=c,
                          presampled=tree_map(lambda w: w[share],
                                              presampled))
    source = masks or BernoulliMasks(generator, samples)
    return mc_predict(model, state, x, samples=c,
                      masks=SampleMasks(source, share))


def sharded_mc_predict(model, state, x, mesh: Mesh, *, samples: int,
                       mode: str = "int", draw=None,
                       generator: Optional[torch.Generator] = None,
                       presampled=None, masks=None, noise=None,
                       ensemble: bool = False):
    """mc_predict's outputs (sample axis in front, all S samples, the same
    on every rank) with the samples sharded over the mesh's last axis:
    this rank computes its share (`sample_share`, `local_outputs`), the
    shares are all-gathered in rank order; the given draws as for
    local_outputs."""
    if not (ensemble or model.stochastic or model.dropout_p > 0):
        # one deterministic forward, repeated over the samples: every rank
        # computes it as one process does; there is nothing to shard
        return mc_predict(model, state, x, samples=samples, mode=mode,
                          generator=generator)
    own = local_outputs(model, state, x, sample_share(mesh, samples),
                        samples, mode=mode, draw=draw, generator=generator,
                        presampled=presampled, masks=masks, noise=noise,
                        ensemble=ensemble)
    group = mesh.group(mesh.axis_names[-1])
    return _each(own, lambda o: all_gather_rows(o, group))


def make_sharded_mc_eval(model, mode: str, mesh: Mesh,
                         samples: int, ensemble: bool = False, draw=None):
    """MC evaluation of one batch with the sample axis sharded over the
    mesh: step(state, metric_state, x, y, generator=None, **given) ->
    (metric_state, aggregated output), the same on every rank; `given`:
    presampled, masks or noise, as sharded_mc_predict takes them."""
    def step(state, metric_state, x, y, generator=None, **given):
        outs = sharded_mc_predict(model, state, x, mesh, samples=samples,
                                  mode=mode, draw=draw, generator=generator,
                                  ensemble=ensemble, **given)
        agg = aggregate(outs, model.task)
        if model.task == "classification":
            return M.cls_metrics_update(metric_state, agg, y), agg
        return M.reg_metrics_update(metric_state, *agg, y), agg

    return step
