"""The epoch loop's checkpoint policy (`Trainer.train_loop`) and the scalar
writer: the port against qbn_tpu's `Trainer.train_loop`, on the CPU.

Both loops run over the same scripted epochs: `train_epoch` and
`eval_epoch` are replaced on each trainer by functions that return the
same metrics per epoch (validation key metrics drawn with numpy, with
spikes), and the state is the epoch count. qbn_tpu's and the port's
`save_variables` are replaced by recorders, so each run gives the list
of (file name, state) it saved, in order. The cases cover SGHMC's
posterior snapshots (every 2nd epoch from burn-in on, within the last
samples * 2), `sghmc_guard`, best-only against save-last (whose
deferred file is written every 25 epochs and after the last), runs with
and without validation, classification and regression key metrics, and
a regression fold's special_info. The writers' scalars.jsonl lines are
compared without their wall_time. Everything is exact: no float
arithmetic differs between the two loops.
"""

import json

import numpy as np
import pytest

import qbn_tpu.training.trainer as JT
from qbn_tpu.config import Config as JConfig
from qbn_tpu.evaluation.writer import ScalarWriter as JWriter

import qbn_tpu_torch.training.trainer as TT
from qbn_tpu_torch.config import Config
from qbn_tpu_torch.evaluation.writer import ScalarWriter

CASES = {
    # name: (config overrides, task, with validation, special_info)
    "sghmc_save_last": (dict(optimizer="sghmc", epochs=20, burnin_epochs=4,
                             samples=3), "classification", True, ""),
    "sghmc_best_only": (dict(optimizer="sghmc", epochs=20, burnin_epochs=4,
                             samples=3, save_last=False),
                        "classification", True, ""),
    "sghmc_guard": (dict(optimizer="sghmc", epochs=24, burnin_epochs=2,
                         samples=5, sghmc_guard=0.05), "classification",
                    True, ""),
    "sghmc_no_valid_fold": (dict(optimizer="sghmc", epochs=12,
                                 burnin_epochs=3, samples=3), "regression",
                            False, "_housing_0"),
    "sghmc_burnin_late": (dict(optimizer="sghmc", epochs=16,
                               burnin_epochs=13, samples=7),
                          "regression", True, "_power_2"),
    "adam_best_only": (dict(epochs=12, save_last=False), "classification",
                       True, ""),
    "adam_save_last_flush": (dict(epochs=30), "regression", True,
                             "_housing_4"),
    "adam_no_valid": (dict(epochs=4, save_last=False), "classification",
                      False, ""),
}


def _script(task, epochs, seed=0):
    """Per epoch: train metrics and validation metrics whose key metric
    wanders down with spikes (a chain that hops to a bad mode)."""
    rng = np.random.default_rng(seed)
    key = "error" if task == "classification" else "rmse"
    val = 0.9 - 0.02 * np.arange(epochs) + rng.normal(0, 0.03, epochs)
    val[rng.random(epochs) < 0.25] += 0.2
    train = [{"obj": float(10 - e), "main_obj": float(9 - e), "kl": 1.0,
              key: float(0.5 - 0.01 * e)} for e in range(epochs)]
    valid = [{key: float(v), "nll": float(2 * v)} for v in val]
    return train, valid


class _Saves:
    def __init__(self):
        self.log = []

    def __call__(self, variables, path):
        self.log.append((path.rsplit("/", 1)[-1], variables["epoch"]))


def _run_jax(cfg, train, valid, special_info, writer, monkeypatch):
    saves = _Saves()
    monkeypatch.setattr(JT, "save_variables", saves)
    tr = JT.Trainer.__new__(JT.Trainer)
    tr.cfg, tr.writer, tr.epoch = cfg, writer, 0
    tr.valid_loader = valid and object()
    tr.train_epoch = lambda s: (s + 1, dict(train[s]))
    tr.eval_epoch = lambda s, _loader, seed: (s, dict(valid[seed]))
    tr.variables = lambda s: {"epoch": s}
    state, best = tr.train_loop(0, special_info=special_info)
    return saves.log, state, best


def _run_port(cfg, train, valid, special_info, writer, monkeypatch):
    saves = _Saves()
    monkeypatch.setattr(TT, "save_variables", saves)
    tr = TT.Trainer.__new__(TT.Trainer)
    tr.cfg, tr.writer, tr.history = cfg.replace(save="run"), writer, []
    tr.train_epoch = lambda s, _b: (s + 1, dict(train[s]))
    tr.eval_epoch = lambda s, _b, seed: (s, dict(valid[seed]))
    tr.variables = lambda s: {"epoch": s}
    state, best = tr.train_loop(0, [None], [None] if valid else None,
                                special_info)
    assert [r["epoch"] for r in tr.history] == list(range(cfg.epochs))
    return saves.log, state, best


def _lines(path):
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    for r in rows:
        assert isinstance(r.pop("wall_time"), float)
    return rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_loop_saves_what_qbn_tpu_saves(case, tmp_path, monkeypatch):
    over, task, with_valid, info = CASES[case]
    monkeypatch.delenv("QBN_CKPT_FLUSH", raising=False)
    train, valid = _script(task, over["epochs"], seed=len(case))
    jw, tw = JWriter(str(tmp_path / "j")), ScalarWriter(str(tmp_path / "t"))
    jlog, jstate, jbest = _run_jax(
        JConfig(task=task, save="run", **over), train,
        valid if with_valid else None, info, jw, monkeypatch)
    tlog, tstate, tbest = _run_port(
        Config(task=task, **over), train, valid if with_valid else None,
        info, tw, monkeypatch)
    jw.close()
    tw.close()
    print(f"{case}: saves {tlog}")
    assert tlog == jlog
    assert (tstate, tbest) == (jstate, jbest)
    assert _lines(tw.path) == _lines(jw.path)
    assert tw.path.endswith("scalars.jsonl")


def test_snapshot_epochs_and_names():
    """sghmc_save_last's snapshots: even epochs from burn-in (4) on, within
    the last samples * 2 = 6 epochs of 20 (14, 16, 18), named
    weights_<epoch>.msgpack; the other epochs' deferred save-last file
    weights.msgpack written after the last epoch. A fold's snapshots carry
    its special_info: weights_housing_0_<epoch>.msgpack."""
    mp = pytest.MonkeyPatch()
    try:
        over, task, _v, _i = CASES["sghmc_save_last"]
        train, valid = _script(task, over["epochs"], 1)
        log, _s, _b = _run_port(Config(**over), train, valid, "", None, mp)
        assert log == [("weights_14.msgpack", 15), ("weights_16.msgpack", 17),
                       ("weights_18.msgpack", 19), ("weights.msgpack", 20)]
        over, task, _v, info = CASES["sghmc_no_valid_fold"]
        train, valid = _script(task, over["epochs"], 1)
        log, _s, _b = _run_port(Config(task=task, **over), train, None, info,
                                None, mp)
        assert [n for n, _e in log] == [
            "weights_housing_0_6.msgpack", "weights_housing_0_8.msgpack",
            "weights_housing_0_10.msgpack", "weights_housing_0.msgpack"]
    finally:
        mp.undo()


def test_no_save_dir_writes_nothing(monkeypatch):
    """With no cfg.save the loop trains and records its history and the
    best key metric, and saves no file."""
    saves = _Saves()
    monkeypatch.setattr(TT, "save_variables", saves)
    over, task, _v, _i = CASES["sghmc_save_last"]
    train, valid = _script(task, over["epochs"], 2)
    tr = TT.Trainer.__new__(TT.Trainer)
    tr.cfg, tr.writer, tr.history = Config(**over), None, []
    tr.train_epoch = lambda s, _b: (s + 1, dict(train[s]))
    tr.eval_epoch = lambda s, _b, seed: (s, dict(valid[seed]))
    state, best = tr.train_loop(0, [None], [None])
    assert saves.log == [] and state == over["epochs"]
    assert best == min(v["error"] for v in valid)
