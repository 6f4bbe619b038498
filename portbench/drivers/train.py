"""Float training through `qbn_tpu_torch.training.trainer.Trainer`.

Traffic keys: "images" (the training split's size), "image_shape",
"classes", "batch", "checked_steps", "timed_check" ({"after", "span"}:
the window's checked steps begin at a unit drawn from the seed in
after .. after + span).

Set-up builds one trainer (the configuration's model, Adam from
`build_optimizer`, the noise of a generator on the card) and one state
from weights the benchmark draws from the seed on the card, and the
port's `ArrayLoader` over a training split made from the seed (shuffle,
crop and flip on the card, CIFAR normalisation). It drives that trainer
through its first `checked_steps` steps with `train_epoch`, one batch at
a time from the loader's first epoch, and records them; then one step
at the epoch's ragged batch size, so that the window meets no shape it
has not run. The window goes on with the same trainer, state and
loader: one `train_epoch` over its first units; then the checked steps,
each a `train_epoch` of one batch (a call reports its last step's loss
alone), recorded from a copy of the state, Adam's state and the noise
generator's state taken just before them; then `train_epoch` over the
rest of the epoch, and epoch after epoch, until --seconds have passed.
After it the plain reference follows both runs of checked steps: the
first from the same weights, the timed ones from the copied state, on
the same batches (the loader's permutation, crops and flips drawn again
from its seed) and noise (the generator's normals drawn again in
forward order).
"""

from __future__ import annotations

import itertools
import statistics
import time

import numpy as np
import torch

from portbench import inputs
from portbench.reference import float_resnet as ref
from portbench.reference.data import normalize_cifar
from portbench.tracing import labelled

DATA_SALT, INIT_SALT, NOISE_SALT, LOADER_SALT, WARM_SALT, AT_SALT = \
    2, 5, 6, 7, 8, 9
# the reference's variants put in the program's place (portbench.calibrate):
# the control (TF32 products) and the fault of a step that leaves half of
# each batch out
VARIANTS = {"program": {}, "control": {"tf32": True},
            "half_batch": {"half": True}}


def _seed(seed: int, salt: int, bits: int = 63) -> int:
    return int(inputs.rng(seed, salt).integers(0, 2 ** bits - 1))


def _copy(tree):
    return {k: v.detach().clone() for k, v in ref.leaves(tree)}


def _tree(flat):
    """The nested tree of {path: tensor}, copied."""
    out = {}
    for path, v in flat.items():
        ref._set(out, path, v.clone())
    return out


class Steps:
    """A run of checked steps of the program: the state before them and
    what each step left."""

    def __init__(self, state, first_batch: int, noise_state):
        self.first_batch, self.noise_state = first_batch, noise_state
        self.p0 = _copy(state.params)
        self.s0 = _copy(state.model_state["batch_stats"])
        opt = state.opt_state
        self.adam = {"mu": _copy(opt["mu"]), "nu": _copy(opt["nu"]),
                     "count": opt["count"].detach().clone()}
        self.losses = []

    def record(self, state, logs):
        self.losses.append(logs["obj"])
        if len(self.losses) == 1:
            self.mu1 = _copy(state.opt_state["mu"])
            self.s1 = _copy(state.model_state["batch_stats"])
        self.p_end = _copy(state.params)

    def grad1(self):
        """The first step's gradient as Adam got it: from its first moment
        before and after the step."""
        return {k: (self.mu1[k] - ref.B1 * self.adam["mu"][k]) / (1 - ref.B1)
                for k in self.mu1}


class Session:
    def __init__(self, cell, seed: int, device):
        self.seed, self.device = int(seed), device
        self.traffic, self.config = cell.traffic, cell.config
        self.batch = int(self.traffic["batch"])
        self.n_check = int(self.traffic["checked_steps"])
        at = self.traffic["timed_check"]
        self.check_at = int(at["after"]) + int(
            inputs.rng(self.seed, AT_SALT).integers(0, int(at["span"])))

    def setup(self):
        from qbn_tpu_torch.config import Config
        from qbn_tpu_torch.data.loaders import ArrayLoader
        from qbn_tpu_torch.models import factory
        from qbn_tpu_torch.ops.stochastic import GeneratorNoise
        from qbn_tpu_torch.training.optim import build_optimizer
        from qbn_tpu_torch.training.trainer import Trainer

        dev, t, tr = self.device, self.traffic, self.config["train"]
        self.x, self.y = inputs.images(int(t["images"]), t["image_shape"],
                                       int(t["classes"]), self.seed,
                                       DATA_SALT)
        self.loader_seed = _seed(self.seed, LOADER_SALT, 32)
        loader = ArrayLoader(self.x, self.y, self.batch, shuffle=True,
                             seed=self.loader_seed, augment=True,
                             normalize="cifar", device=dev)
        self.n_batches = len(loader)
        # both runs of checked steps lie in the first epoch's full batches
        if 2 * self.n_check + self.check_at > len(self.x) // self.batch:
            raise ValueError("the timed checked steps pass the first epoch")
        self.cfg = Config(**tr["port"])
        model = factory.build_model(self.cfg)
        init_gen = torch.Generator(device=dev).manual_seed(
            _seed(self.seed, INIT_SALT))
        params, stats = ref.init_state(self.config["architecture"],
                                       tr["init"], init_gen, dev)
        tx, _schedule = build_optimizer(self.cfg, len(loader))
        self.noise_gen = torch.Generator(device=dev).manual_seed(
            _seed(self.seed, NOISE_SALT))
        trainer = Trainer(model, self.cfg, tx, "float", len(loader),
                          loader.dataset_size,
                          GeneratorNoise(self.noise_gen), dev)
        state = trainer.init_state({"params": params, "batch_stats": stats})
        epoch = iter(loader)
        self.first = Steps(state, 0, self.noise_gen.get_state())
        for _ in range(self.n_check):
            state, logs = trainer.train_epoch(state,
                                              itertools.islice(epoch, 1))
            self.first.record(state, logs)
        # the ragged batch of an epoch's end, once
        ragged = len(self.x) % self.batch
        if ragged:
            r = inputs.rng(self.seed, WARM_SALT)
            idx = r.choice(len(self.x), ragged, replace=False)
            warm = ArrayLoader(self.x[idx], self.y[idx], ragged,
                               augment=True, normalize="cifar", device=dev)
            state, _ = trainer.train_epoch(state, warm)
        torch.cuda.synchronize(dev)
        self.trainer, self.state, self.loader = trainer, state, loader
        self.epoch = epoch

    def attach(self, tracer):
        return tracer.ranges

    def window(self, seconds: float, tracer):
        rows = []
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def feed(it, stop_at_end=True):
            """The batches of `it`; stop_at_end: until the window's end."""
            for xb, yb in labelled(it, tracer):
                if rows:
                    tracer.step(len(rows), rows[-1])
                if stop_at_end and \
                        tracer.done(time.perf_counter() >= t_end):
                    return
                rows.append(int(xb.shape[0]))
                yield xb, yb

        train, epoch = self.trainer.train_epoch, self.epoch
        state, _m = train(self.state,
                          feed(itertools.islice(epoch, self.check_at), False))
        self.timed = Steps(state, self.n_check + self.check_at,
                           self.noise_gen.get_state())
        for _ in range(self.n_check):
            state, logs = train(state, feed(itertools.islice(epoch, 1),
                                            False))
            self.timed.record(state, logs)
        while not tracer.done(time.perf_counter() >= t_end):
            state, _m = train(state, feed(epoch))
            epoch = iter(self.loader)
        torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        tracer.close()
        self.rows = rows
        return {"elapsed": elapsed, "units": len(rows),
                "metrics": {"train_throughput": sum(rows) / elapsed},
                "attempted": len(rows)}

    def release(self):
        del self.trainer, self.state, self.loader, self.epoch
        torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------
    def reference(self, steps: Steps, tf32: bool = False,
                  half: bool = False):
        """The reference's run of `steps`: from the weights drawn again
        from the seed and a fresh Adam (the first steps), or from the
        program's copied state (the timed steps: the reference can only
        follow those from it; PERF.md)."""
        dev = self.device
        arch, tr = self.config["architecture"], self.config["train"]
        if steps is self.first:
            init_gen = torch.Generator(device=dev).manual_seed(
                _seed(self.seed, INIT_SALT))
            params, stats = ref.init_state(arch, tr["init"], init_gen, dev)
            adam = None
        else:
            params, stats = _tree(steps.p0), _tree(steps.s0)
            adam = steps.adam
        gen = torch.Generator(device=dev)
        gen.set_state(steps.noise_state)

        def noise(shape):
            return torch.randn(tuple(shape), generator=gen, device=dev)

        hp = {"learning_rate": tr["port"]["learning_rate"],
              "gamma": tr["port"]["gamma"],
              "sigma_prior": tr["port"]["sigma_prior"]}
        batches = self.batches(steps.first_batch, self.n_check)
        if half:
            batches = [(x[:len(x) // 2], y[:len(y) // 2]) for x, y in batches]
        return ref.train(params, stats, batches, noise, arch, hp,
                         self.n_batches, tf32=tf32, adam=adam)

    def batches(self, first: int, count: int):
        """Batches first .. first + count of the loader's first epoch,
        drawn again: its permutation, then each batch's crop rows, crop
        columns and flips, from its seed."""
        rng = np.random.RandomState(self.loader_seed)
        perm = rng.permutation(len(self.x))
        out = []
        for b in range(first + count):
            sel = perm[b * self.batch:(b + 1) * self.batch]
            n = len(sel)
            ys, xs = rng.randint(0, 9, n), rng.randint(0, 9, n)
            flip = rng.rand(n) < 0.5
            if b < first:
                continue
            x = torch.from_numpy(self.x[sel]).to(self.device)
            fl = torch.from_numpy(flip).to(self.device)[:, None, None, None]
            x = torch.where(fl, x.flip(2), x)
            pad = torch.nn.functional.pad(x, (0, 0, 4, 4, 4, 4))
            h, w = x.shape[1:3]
            crops = torch.stack([pad[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
                                 for i in range(n)])
            out.append((normalize_cifar(crops),
                        torch.from_numpy(self.y[sel]).to(self.device)))
        return out

    def numbers(self, steps: Steps, r):
        """The compared numbers of a run of the program's checked steps
        against the reference's run r (PERF.md gives the readings): each
        step's loss; leaf by leaf, the first gradient's norm and the
        running statistics' change in the first step (worst leaf); and
        the parameters' change over the steps of the median leaf. Adam's
        update of an element whose gradient is near 0 flips with
        rounding: one such element sways a small leaf's change and the
        later steps' statistics, so those are not compared leaf by
        leaf. A leaf's gap of norms is taken over the larger of its
        reference norm and the median leaf's. Also the leaves left out
        of the change: those whose reference gradient is under a
        thousandth of the median leaf's."""
        losses = [float(v) for v in steps.losses]
        loss = max(abs(a - b) / abs(b) for a, b in zip(losses, r["loss"]))
        gnorm = {k: float(v.norm()) for k, v in r["grad1"].items()}
        med_g = statistics.median(gnorm.values())
        moved = [k for k in gnorm if gnorm[k] >= 1e-3 * med_g]

        def gaps(prog, refs, keys):
            norms = {k: float(refs[k].norm()) for k in keys}
            med = statistics.median(norms.values())
            return [abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med)
                    for k in keys]

        grad = max(gaps(steps.grad1(), r["grad1"], list(gnorm)))
        dp = {k: steps.p_end[k] - steps.p0[k] for k in moved}
        dr = {k: r["params"][k] - steps.p0[k] for k in moved}
        update = statistics.median(gaps(dp, dr, moved))
        s0 = steps.s0
        ds = {k: steps.s1[k] - s0[k] for k in s0}
        dsr = {k: r["stats1"][k] - s0[k] for k in s0}
        stats = max(gaps(ds, dsr, list(s0)))
        return ([("loss_gap", loss), ("grad_gap", grad),
                 ("update_gap", update), ("stats_gap", stats)],
                sorted(set(gnorm) - set(moved)))

    def check(self, tf32: bool = False, half: bool = False):
        """The numbers of both runs of checked steps, the first (".first")
        and the timed (".timed"), against the reference; tf32: the
        control (the reference with TF32 products); half: the fault of a
        step that leaves half of each batch out."""
        out, self.left_out = [], []
        for tag, steps in (("first", self.first), ("timed", self.timed)):
            nums, left = self.numbers(
                steps, self.reference(steps, tf32, half))
            out += [(f"{name}.{tag}", v) for name, v in nums]
            self.left_out += [(tag,) + k for k in left]
        return out, 2 * self.n_check

    def facts(self):
        return {"architecture": self.config["architecture"]}
