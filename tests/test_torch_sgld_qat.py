"""The QAT of an SGHMC run, snapshot by snapshot (`flows.qat` with
cfg.method 'sgld', qbn_tpu's run_qat_classification and
run_qat_regression loops over `_qat_one`), on the CPU: a short SGHMC run
of the LeNet (28x28x1) and of the regression MLP (13 features, a fold's
special_info) through `flows.fit` writes its posterior snapshots; then
`flows.qat` fine-tunes and converts each of the last `samples`, and
`load_trained` stacks the converted members. Each member is held against
qbn_tpu:

- its QAT fine-tune: qbn_tpu's quantised init with the same snapshot
  loaded (`load_variables`), then qbn_tpu's QAT steps
  (make_train_step(jit_compile=False), the sgld QAT preset: SGD with
  momentum) on the same batches: params within 1e-7 absolute, observers
  1e-5 relative (atol 1e-6): float32 sums in another order, and an
  update of lr 1e-5 times the gradient;
- its convert: qbn_tpu's `convert_model` of the port's fine-tuned member:
  qconst as in tests/test_torch_convert.py (bitwise; these deterministic
  members have no std_codes to differ).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training import metrics as JM
from qbn_tpu.training.checkpoint import list_snapshots as j_list
from qbn_tpu.training.checkpoint import load_variables as j_load
from qbn_tpu.training.optim import build_optimizer as j_optimizer
from qbn_tpu.training.trainer import TrainState as JState
from qbn_tpu.training.trainer import make_train_step as j_make_step
from qbn_tpu.utils import init_variables as j_init

from qbn_tpu_torch.convert import from_jax_state, to_numpy_state
from qbn_tpu_torch.evaluation import ensemble as TE
from qbn_tpu_torch.flows import fit, qat
from qbn_tpu_torch.models.factory import load_trained
from qbn_tpu_torch.presets import preset

from test_torch_convert import assert_qconst_match, j_qconst

SAMPLES, EPOCHS, N_BATCHES = 2, 6, 2
TIERS = {"mnist": ((28, 28, 1), 4, ""),
         "regression": ((13,), 8, "_housing_0")}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _batches(tier, seed):
    shape, b, _info = TIERS[tier]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_BATCHES):
        x = rng.random((b,) + shape, dtype=np.float32)
        y = (rng.standard_normal((b, 1)).astype(np.float32)
             if tier == "regression" else rng.integers(0, 10, b))
        out.append((x, y))
    return out


@pytest.fixture(scope="module", params=sorted(TIERS))
def run(request, tmp_path_factory):
    """The float SGHMC run, then the per-snapshot QAT, in a temporary
    directory."""
    tier = request.param
    shape, _b, info = TIERS[tier]
    root = tmp_path_factory.mktemp(tier)
    batches = _batches(tier, 0)
    over = dict(epochs=EPOCHS, burnin_epochs=1, samples=SAMPLES, seed=3)
    _m, _t, _s = fit(preset("sgld", tier, **over), batches, device="cpu",
                     save_dir=str(root / "float"), special_info=info)
    qover = dict(epochs=1, samples=SAMPLES, seed=3)
    qcfg = preset("sgld", tier, "qat", **qover)
    model, trainer, stacked = qat(qcfg, str(root / "float"), batches,
                                  device="cpu", save_dir=str(root / "q"),
                                  special_info=info)
    return dict(tier=tier, shape=shape, info=info, root=root,
                batches=batches, stacked=stacked, qover=qover,
                jcfg=j_preset("sgld", tier, "qat", input_size=shape,
                              **qover))


def test_snapshots_written_and_converted(run):
    """Snapshots at the even epochs from burn-in on within the last
    SAMPLES * 2 of EPOCHS (2 and 4), under the fold's special_info; the
    QAT directory holds one converted file per snapshot, same names."""
    stem = "weights" + run["info"]
    names = sorted(os.listdir(run["root"] / "float"))
    assert names == sorted(["config.json", "scalars.jsonl", f"{stem}.msgpack",
                            f"{stem}_2.msgpack", f"{stem}_4.msgpack"])
    qnames = sorted(os.listdir(run["root"] / "q"))
    assert qnames == sorted(["config.json", "scalars.jsonl",
                             f"{stem}_2.msgpack", f"{stem}_4.msgpack"])
    # qbn_tpu lists the same snapshots, in the same order
    prefix = run["info"][1:] + "_" if run["info"] else ""
    assert [os.path.basename(p) for p in j_list(str(run["root"] / "float"),
                                                prefix)] == \
        [f"{stem}_2.msgpack", f"{stem}_4.msgpack"]
    assert TE.members(run["stacked"]) == SAMPLES


def test_load_trained_stacks_the_members(run):
    cfg, model, state = load_trained(str(run["root"] / "q"), device="cpu",
                                     special_info=run["info"])
    assert (model.method, cfg.q, cfg.at) == ("sgld", True, True)
    assert TE.members(state) == SAMPLES
    got = dict(_leaves(to_numpy_state(state)))
    for p, v in _leaves(to_numpy_state(run["stacked"])):
        np.testing.assert_array_equal(got[p], v, err_msg=str(p))


def _j_fine_tune(run, snapshot):
    """qbn_tpu's _qat_one up to convert: the quantised init with the
    snapshot loaded, one epoch of QAT steps on the run's batches."""
    jcfg = run["jcfg"]
    jm = j_build(jcfg)
    jv = j_load(j_init(jm, jax.random.PRNGKey(jcfg.seed),
                       jnp.zeros((1,) + run["shape"]), quantized=True),
                snapshot)
    jtx, _ = j_optimizer(jcfg, N_BATCHES)
    n_points = sum(len(y) for _x, y in run["batches"])
    step = j_make_step(jm, jcfg, jtx, "qat", N_BATCHES, n_points,
                       jit_compile=False)
    jv = dict(jv)
    params = jv.pop("params")
    st = JState(params=params, model_state=jv, opt_state=jtx.init(params),
                step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(1))
    metrics = (JM.reg_metrics_init() if run["tier"] == "regression"
               else JM.cls_metrics_init())
    for x, y in run["batches"]:
        st, metrics, _logs = step(st, metrics, jnp.asarray(x),
                                  jnp.asarray(y))
    return jm, jax.tree.map(np.asarray, {"params": st.params,
                                         **st.model_state})


@pytest.mark.parametrize("member", range(SAMPLES))
def test_each_member_against_qbn_tpu(run, member):
    prefix = run["info"][1:] + "_" if run["info"] else ""
    snapshot = j_list(str(run["root"] / "float"), prefix)[member]
    ours = to_numpy_state(TE.member(run["stacked"], member))
    jm, jstate = _j_fine_tune(run, snapshot)
    for col, rtol, atol in (("params", 0, 1e-7), ("quant", 1e-5, 1e-6)):
        want = dict(_leaves(jstate[col]))
        got = dict(_leaves(ours[col]))
        assert want.keys() == got.keys(), col
        for p in want:
            np.testing.assert_allclose(got[p], want[p], rtol=rtol,
                                       atol=atol, err_msg=f"{col} {p}")
    want = j_qconst(jm, ours, run["batches"][0][0])["qconst"]
    assert_qconst_match(from_jax_state(ours)["qconst"], want)
