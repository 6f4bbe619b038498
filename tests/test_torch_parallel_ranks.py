"""The rank side of tests/test_torch_parallel*.py: scenarios that run in
each process of a gloo group on the CPU (qbn_tpu_torch.parallel.launch
starts them), returning numpy results from rank 0. This module imports
neither JAX nor qbn_tpu: the ranks are fresh processes that import only
it and the port. It holds no tests.

`run_scenarios(mesh, scenarios)` runs {name: (function name, kwargs)} in
order and returns {name: result}; every rank runs every scenario, so that
their collectives pair up.
"""

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from qbn_tpu_torch.config import Config, QuantConfig
from qbn_tpu_torch.convert import from_jax_state, to_numpy_state
from qbn_tpu_torch.evaluation import mc
from qbn_tpu_torch.evaluation.ensemble import stack_variables
from qbn_tpu_torch.models.architectures import ResNet
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import (
    BernoulliMasks, DrawLog, GeneratorNoise, QueueMasks, QueueNoise)
from qbn_tpu_torch.parallel import mesh as PM
from qbn_tpu_torch.parallel.sharded import (
    make_sharded_eval_step, make_sharded_mc_eval, make_sharded_train_step,
    sharded_mc_predict)
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training import metrics as TM
from qbn_tpu_torch.training import trainer as T
from qbn_tpu_torch.training.optim import build_optimizer, tree_map
from qbn_tpu_torch.utils import apply_model, convert_model, init_variables

WIDTHS = (8, 16, 16, 16)


def run_scenarios(mesh, scenarios):
    torch.set_num_threads(1)
    return {name: globals()[fn](mesh, **kw)
            for name, (fn, kw) in scenarios.items()}


def _gather(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _np(tree):
    return to_numpy_state(tree)


def _digest(tree) -> str:
    """A digest of every leaf's bytes, in order."""
    h = hashlib.sha1()

    def walk(t):
        if isinstance(t, dict):
            for k in t:
                walk(t[k])
        else:
            h.update(np.ascontiguousarray(
                t.detach().cpu().numpy()).tobytes())

    walk(tree)
    return h.hexdigest()


def _error(fn):
    try:
        fn()
    except Exception as e:       # the scenario reports what was raised
        return f"{type(e).__name__}: {e}"
    return None


# -- the mesh -----------------------------------------------------------

def mesh_info(mesh, rows=8):
    """The mesh's layout on every rank, mesh_from_config's answers and
    shard_batch's rows."""
    base = Config()
    x = torch.arange(rows)
    here = dict(rank=mesh.rank,
                index={a: mesh.axis_index(a) for a in mesh.axis_names},
                groups={a: dist.get_process_group_ranks(mesh.group(a))
                        for a in mesh.axis_names},
                rows=PM.shard_batch(x, mesh).tolist(),
                pair=[t.tolist() for t in PM.shard_batch((x, x * 2), mesh)],
                device=str(mesh.device))
    cfg_mesh = PM.mesh_from_config(base.replace(mesh_shape=mesh.shape))
    return dict(
        shape=mesh.shape, axis_names=mesh.axis_names, size=mesh.size,
        backend=mesh.backend, ranks=_gather(here),
        none=PM.mesh_from_config(base) is None,
        from_config=(cfg_mesh.shape, cfg_mesh.axis_names),
        too_many=_error(lambda: PM.mesh_from_config(
            base.replace(mesh_shape=(2 * mesh.size,)))),
        other=_error(lambda: PM.mesh_from_config(
            base.replace(mesh_shape=(mesh.size, 2)))))


# -- training -------------------------------------------------------------

def _model(method, arch, phase):
    """The port's model of a training scenario: the mnist preset's LeNet
    or the narrow ResNet (tests/test_torch_resnet_train.py's)."""
    if arch == "lenet":
        cfg = preset(method, "mnist", phase, tpu_fused=True, epochs=2)
        return build_model(cfg), cfg
    cfg = preset(method, "cifar", phase, tpu_fused=True, epochs=2)
    model = ResNet(quant=QuantConfig(enabled=phase == "qat", tpu_fused=True),
                   widths=WIDTHS, stochastic=method == "bbb",
                   dropout_p=0.15 if method == "mcdropout" else 0.0,
                   sigma_prior=0.05)
    model.method, model.task = method, "classification"
    return model, cfg


def _state(tx, variables):
    """The TrainState of a numpy variable tree: params that require
    grad, a fresh optimiser state."""
    tree = from_jax_state(variables)
    params = tree_map(lambda p: p.requires_grad_(), tree.pop("params"))
    return T.TrainState(params=params, model_state=tree,
                        opt_state=tx.init(_detach(params)))


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def _step_result(state, metric_state, logs):
    return dict(params=_np(state.params), model_state=_np(state.model_state),
                opt_state=_np(state.opt_state),
                logs={k: float(v) for k, v in logs.items()},
                metrics={k: v.numpy() for k, v in metric_state.items()},
                digest=_digest({"p": state.params, "s": state.model_state}))


def train_step(mesh, method, arch, phase, variables, x, y, normals, masks,
               n_batches, n_points):
    """One training step from `variables` on the global batch (x, y) with
    the given global draws: the sharded step (this rank's rows) and the
    one-process step (the whole batch). Returns rank 0's results of
    both, and every rank's digest of its sharded state."""
    model, cfg = _model(method, arch, phase)
    mode = "qat" if phase == "qat" else "float"
    tx, _ = build_optimizer(cfg, n_batches)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    single = T.make_train_step(model, cfg, tx, mode, n_batches, n_points)
    s1, m1, l1 = single(_state(tx, variables), TM.cls_metrics_init(), xt, yt,
                        QueueNoise(normals), QueueMasks(masks))
    sharded = make_sharded_train_step(model, cfg, tx, mode, n_batches,
                                      n_points, mesh)
    xb, yb = PM.shard_batch((xt, yt), mesh)
    noise, qmasks = QueueNoise(normals), QueueMasks(masks)
    s2, m2, l2 = sharded(_state(tx, variables), TM.cls_metrics_init(), xb,
                         yb, noise, qmasks)
    assert not noise.queue and not qmasks.queue
    r2 = _step_result(s2, m2, l2)
    return dict(single=_step_result(s1, m1, l1), sharded=r2,
                digests=_gather(r2["digest"]), rows=len(yb))


def partial_batch(mesh, variables, x, y):
    """A batch that does not divide over the mesh: the Trainer takes the
    one-process step on every rank; the state equals a mesh-less
    Trainer's bitwise."""
    model, cfg = _model("bbb", "lenet", "float")
    tx, _ = build_optimizer(cfg, 2)
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        g = torch.Generator().manual_seed(3)
        tr = T.Trainer(model, cfg, tx, "float", 2, 2 * len(y),
                       GeneratorNoise(g), "cpu", BernoulliMasks(g, 1),
                       mesh=m)
        step, _x, yy = tr._pick(True, torch.from_numpy(x),
                                torch.from_numpy(y))
        st, metrics = tr.train_epoch(_state(tx, variables), [(x, y)])
        out[name] = dict(digest=_digest(st.params), metrics=metrics,
                         sharded=step is not tr.train_step, rows=len(yy))
    return out


def nonfinite(mesh, variables, x, y, normals):
    """A NaN in one rank's rows: the global loss is NaN and every rank
    keeps its params, optimiser state and metric-free state."""
    model, cfg = _model("bbb", "lenet", "float")
    tx, _ = build_optimizer(cfg, 2)
    step = make_sharded_train_step(model, cfg, tx, "float", 2, 2 * len(y),
                                   mesh)
    s0 = _state(tx, variables)
    xb, yb = PM.shard_batch((torch.from_numpy(x), torch.from_numpy(y)),
                            mesh)
    s1, _m, logs = step(s0, TM.cls_metrics_init(), xb, yb,
                        QueueNoise(normals))
    here = dict(nan_in_rows=bool(torch.isnan(xb).any()),
                obj=float(logs["obj"]),
                kept=_digest({"p": s0.params, "o": s0.opt_state}) ==
                _digest({"p": s1.params, "o": s1.opt_state}))
    return _gather(here)


def eval_step(mesh, variables, x, y):
    """The validation step of a QAT LeNet (observers updated), sharded
    against one process, on the same generator's draws."""
    model, cfg = _model("mcdropout", "lenet", "qat")
    tx, _ = build_optimizer(cfg, 2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    out = {}
    for name in ("single", "sharded"):
        g = torch.Generator().manual_seed(11)
        src = GeneratorNoise(g), BernoulliMasks(g, 1)
        if name == "single":
            step = T.make_eval_step(model, cfg, "qat", True)
            xs, ys = xt, yt
        else:
            step = make_sharded_eval_step(model, cfg, "qat", True, mesh)
            xs, ys = PM.shard_batch((xt, yt), mesh)
        st, ms = step(_state(tx, variables), TM.cls_metrics_init(), xs, ys,
                      *src)
        out[name] = dict(quant=_np(st.model_state["quant"]),
                         metrics={k: v.numpy() for k, v in ms.items()})
    return out


def writes(mesh, save_dir, x, y):
    """flows.fit with the config's mesh: the files, and which rank wrote
    checkpoints."""
    from qbn_tpu_torch import flows
    calls = []
    saved = T.save_variables

    def counting(variables, path):
        calls.append(os.path.basename(path))
        return saved(variables, path)

    T.save_variables = counting
    try:
        cfg = preset("pointwise", "mnist", epochs=2, mesh_shape=mesh.shape)
        flows.fit(cfg, [(x, y)], device="cpu", save_dir=save_dir)
    finally:
        T.save_variables = saved
    return dict(calls=_gather(calls), files=sorted(os.listdir(save_dir)))


# -- MC evaluation --------------------------------------------------------

def _int_state(method, tier, seed):
    """A converted (int) state of the port's own making: the quantised
    init, one QAT forward with updates (observers with real ranges),
    convert."""
    cfg = preset(method, tier, "qat", samples=4)
    model = build_model(cfg)
    size = (1,) if tier == "regression" else (28, 28, 1)
    v = init_variables(model, torch.Generator().manual_seed(seed), size,
                       "cpu", quantized=True)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.rand((4,) + size, generator=g)
    with torch.no_grad():
        _o, _kl, v = apply_model(model, v, x, train=True, mode="qat",
                                 update_stats=True, noise=GeneratorNoise(g),
                                 masks=BernoulliMasks(g, 1))
    v = {k: _detach(t) for k, t in v.items()}
    return model, convert_model(model, v, x)


def _float_state(method, seed):
    cfg = preset(method, "mnist")
    model = build_model(cfg)
    v = init_variables(model, torch.Generator().manual_seed(seed),
                       (28, 28, 1), "cpu")
    return model, {k: _detach(t) for k, t in v.items()}


def _outputs(metric_state, outs):
    def arr(o):
        return (tuple(t.numpy() for t in o) if isinstance(o, tuple)
                else o.numpy())
    return dict(metrics={k: v.numpy() for k, v in metric_state.items()},
                outs=[arr(o) for o in outs])


def _given(model, state, case, x, samples, seed):
    """Draws for all samples from a numpy generator, in the form the
    case's path takes them: each plan layer's (S, ...) normals (BBB
    INT), each dropout site's (S, ...) masks (MC-Dropout INT), or every
    sample's weight normals in call order (BBB float); the shapes read
    from a recording forward."""
    rng = np.random.default_rng(seed)
    if case == "bbb":
        return [rng.standard_normal((samples, *shape)).astype(np.float32)
                for shape in mc.PosteriorDraw(state, samples).shapes]
    log = DrawLog(samples if case == "mcdropout" else 1)
    mode = "int" if case == "mcdropout" else "float"
    mc.mc_predict(model, state, x, samples=log.samples, mode=mode,
                  masks=log.masks, noise=log)
    if case == "mcdropout":
        return [(rng.random((samples, *c[1])) < c[2]).astype(np.float32)
                for c in log.calls]
    return [rng.standard_normal(c[1]).astype(np.float32)
            for _s in range(samples) for c in log.calls]


def mc_eval(mesh, case, samples, x, y, given_seed=None):
    """One-process and sample-sharded `evaluate` of a state of the port's
    own making, seeded from the same generator seed; with given_seed, the
    per-sample outputs of given draws too (presampled codes, masks or
    noise for all samples, `_given`), through mc_predict and
    sharded_mc_predict."""
    mode = "float" if case == "bbb-float" else "int"
    if case == "bbb-float":
        model, state = _float_state("bbb", 5)
    elif case == "sgld":
        members = [_int_state("pointwise", "mnist", 20 + m)[1]
                   for m in range(samples)]
        model = build_model(preset("sgld", "mnist", "qat", samples=samples))
        state = stack_variables(members)
    elif case == "bbb-mlp":
        model, state = _int_state("bbb", "regression", 5)
    else:
        model, state = _int_state(case, "mnist", 5)
    out = {}
    for name, m in (("single", None), ("sharded", mesh)):
        g = torch.Generator().manual_seed(7)
        ms, outs, _sec = mc.evaluate(model, state, [(x, y)], samples, g,
                                     "cpu", mode, mesh=m)
        out[name] = _outputs(ms, outs)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if given_seed is not None:
            given = _given(model, state, case, xt, samples, given_seed)
            for name, m in (("given_single", None), ("given_sharded", mesh)):
                kw = {}
                if case == "bbb":
                    kw["presampled"] = mc.PosteriorDraw(state, samples)(
                        noise=[torch.from_numpy(a) for a in given])
                elif case == "mcdropout":
                    kw["masks"] = QueueMasks(given)
                else:
                    kw["noise"] = QueueNoise(given)
                if m is None:
                    o = mc.mc_predict(model, state, xt, samples=samples,
                                      mode=mode, **kw)
                else:
                    o = sharded_mc_predict(model, state, xt, m,
                                           samples=samples, mode=mode, **kw)
                out[name] = o.numpy()
        if case == "bbb-float":
            step = make_sharded_mc_eval(model, mode, mesh, samples)
            ms, agg = step(state, TM.cls_metrics_init(), xt,
                           torch.from_numpy(y),
                           torch.Generator().manual_seed(9))
            out["step"] = dict(metrics={k: float(v) for k, v in
                                        TM.cls_metrics_compute(ms).items()},
                               agg=agg.numpy())
    out["share"] = _gather(mesh.axis_index(mesh.axis_names[-1]))
    return out


def failing(mesh):
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return "unreachable"


def run_flows(mesh, cfgs, tier="mnist", phase="float"):
    """The runner's rank body (qbn_tpu_torch.run._rank) for each config
    in turn; returns each run's results.json."""
    import json
    from qbn_tpu_torch import run
    out = []
    for cfg in cfgs:
        run._rank(mesh, cfg, tier, phase, None)
        with open(os.path.join(cfg.save, "results.json")) as fh:
            out.append(json.load(fh))
    return out
