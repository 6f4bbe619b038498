"""INT8 Monte-Carlo evaluation through `qbn_tpu_torch.evaluation.mc.evaluate`.

Traffic keys: "images" (the test split's size), "image_shape",
"classes", "batch", "samples", "checked_batches" (how many of the
window's batches the reference recomputes).

Set-up makes the split from the seed (the port's CIFAR reader's dtype and
layout), the INT state from the configuration's rule, and the port's
`ArrayLoader` (no shuffle, CIFAR normalisation); it warms up the split's
two batch shapes. The window feeds the loader's batches, epoch after
epoch, to one call of `evaluate` until `--seconds` have passed; every
batch ends in a device synchronise (evaluate's own). After the window a
sample of the batches, drawn from the seed, is recomputed by the plain
reference (portbench/reference) from the raw inputs: the images, the
committed state, and the evaluation generator's seed.
"""

from __future__ import annotations

import time

import torch

from portbench import inputs
from portbench.cells import ROOT
from portbench.reference import compare, int_resnet, replay, states
from portbench.reference.data import normalize_cifar
from portbench.reference.draw import draw
from portbench.tracing import labelled

DROPOUT_RANGE = "portbench.dropout_site"
WARMUP_SALT, DATA_SALT, GEN_SALT, CHECK_SALT = 1, 2, 3, 4
# the reference's variants put in the program's place (portbench.calibrate):
# the control, one precision below the configuration's int8 weights
VARIANTS = {"program": {}, "control": {"weight_bits": 4}}


class Session:
    def __init__(self, cell, seed: int, device):
        self.seed, self.device = int(seed), device
        self.traffic, self.config = cell.traffic, cell.config
        self.samples = int(self.traffic["samples"])
        self.batch = int(self.traffic["batch"])

    # -- set-up -------------------------------------------------------
    def setup(self):
        from qbn_tpu_torch.config import Config
        from qbn_tpu_torch.data.loaders import ArrayLoader
        from qbn_tpu_torch.evaluation.mc import evaluate
        from qbn_tpu_torch.models import factory

        self._evaluate = evaluate
        rule = self.config["state"]
        if rule["rule"] == "checkpoint":
            cfg, model, state = factory.load_trained(
                str(ROOT / rule["dir"]), device=self.device)
        else:
            cfg = Config(**self.config["port"])
            model = factory.build_model(cfg)
            state = {"qconst": states.to_device(
                states.qconst(self.config, ROOT), self.device)}
        _check_model(model, cfg, self.config)
        self.model, self.state = model, state
        t = self.traffic
        self.x, self.y = inputs.images(int(t["images"]), t["image_shape"],
                                       int(t["classes"]), self.seed,
                                       DATA_SALT)
        self.loader = ArrayLoader(self.x, self.y, self.batch, shuffle=False,
                                  normalize="cifar", device=self.device)
        # the split's two shapes: a full batch and the ragged last one
        first = last = None
        for batch in self.loader:
            first, last = first or batch, batch
        warm = [first, last]
        gen = torch.Generator(device=self.device).manual_seed(
            _gen_seed(self.seed, WARMUP_SALT))
        evaluate(model, state, warm * 2, self.samples, gen, self.device)
        del first, last, warm
        torch.cuda.synchronize(self.device)

    def attach(self, tracer):
        """With a trace: profiler ranges around every dropout site."""
        from qbn_tpu_torch.models.layers import BernoulliDropout
        self._handles = []
        for m in self.model.modules():
            if isinstance(m, BernoulliDropout):
                self._handles.append(m.register_forward_pre_hook(_open))
                self._handles.append(m.register_forward_hook(_close))
        return (DROPOUT_RANGE,) + tracer.ranges

    # -- the window ---------------------------------------------------
    def window(self, seconds: float, tracer):
        rows = []
        gen = torch.Generator(device=self.device).manual_seed(
            _gen_seed(self.seed, GEN_SALT))

        def feed():
            t_end = t0 + seconds
            while True:
                for xb, yb in labelled(self.loader, tracer):
                    if rows:
                        tracer.step(len(rows), rows[-1])
                    if tracer.done(time.perf_counter() >= t_end):
                        return
                    rows.append(int(xb.shape[0]))
                    yield xb, yb

        t0 = time.perf_counter()
        _metrics, outputs, _sec = self._evaluate(
            self.model, self.state, feed(), self.samples, gen, self.device)
        torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        tracer.close()
        self.rows, self.outputs = rows, outputs
        examples = sum(rows)
        return {"elapsed": elapsed, "units": len(rows),
                "metrics": {"eval_throughput":
                            examples * self.samples / elapsed},
                "attempted": len(rows)}

    def release(self):
        self.checked = inputs.sample(int(self.traffic["checked_batches"]),
                                     len(self.rows), self.seed, CHECK_SALT)
        self.kept = {i: self.outputs[i].detach() for i in self.checked}
        del self.outputs, self.model, self.state, self.loader
        for h in getattr(self, "_handles", []):
            h.remove()
        torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------
    def reference(self, indices, weight_bits: int = 8):
        """{batch index: (B, classes) probabilities} of the plain
        reference for the window's batches `indices`."""
        dev = self.device
        cfg = self.config
        arch, p = cfg["architecture"], float(cfg.get("dropout_p", 0.0))
        qc, bounds = compare.int_setting(cfg, ROOT, dev)
        gen_seed = _gen_seed(self.seed, GEN_SALT)
        method = cfg["method"]
        if method == "bbb":
            keys = replay.bbb_keys(gen_seed, indices, dev)
        else:
            masks = replay.mcd_masks(gen_seed, self.rows, indices, arch,
                                     self.samples, p, dev)
        n_per_epoch = -(-len(self.x) // self.batch)
        out = {}
        for i in indices:
            j = i % n_per_epoch
            xb = torch.from_numpy(
                self.x[j * self.batch:(j + 1) * self.batch]).to(dev)
            xb = normalize_cifar(xb)
            kw = {}
            if method == "bbb":
                kw["sampled"] = draw(qc, self.samples, *keys[i], dev)
            else:
                kw["masks"] = masks[i]
            with torch.no_grad():
                out[i] = int_resnet.predictive(
                    qc, xb, arch, bounds, self.samples, method=method, p=p,
                    weight_bits=weight_bits, **kw)
            del kw
        return out

    def check(self, weight_bits: int = 8):
        """[(name, value)] of the numbers compared: the widest gap between
        the window's probabilities and the reference's, over the sampled
        batches."""
        gap = compare.widest_gap(self.kept,
                                 self.reference(self.checked, weight_bits))
        return [("prob_gap", gap)], len(self.checked)

    # -- the facts the per-layer readers take ---------------------------
    def facts(self):
        t = self.traffic
        return {"samples": self.samples, "method": self.config["method"],
                "architecture": self.config["architecture"],
                "image_shape": t["image_shape"],
                "classes": int(t["classes"])}


def _gen_seed(seed: int, salt: int) -> int:
    return int(inputs.rng(seed, salt).integers(0, 2 ** 63 - 1))


def _open(module, args):
    module._portbench_range = torch.profiler.record_function(DROPOUT_RANGE)
    module._portbench_range.__enter__()


def _close(module, args, output):
    module._portbench_range.__exit__(None, None, None)


def _check_model(model, cfg, config):
    """The program runs the configuration as the file states it."""
    arch = config["architecture"]
    widths = [model.stem.features] + [
        getattr(model, names[0]).conv_bn.features for names in model.stages]
    if widths[1:] != list(arch["widths"]) or \
            [len(n) for n in model.stages] != list(arch["blocks"]):
        raise RuntimeError(f"the program's ResNet {widths} does not match "
                           f"the configuration's {arch}")
    prec = config["precision"]
    if (cfg.activation_precision, cfg.weight_precision) != (
            prec["activation_bits"], prec["weight_bits"]) or \
            model.method != config["method"]:
        raise RuntimeError("the program's precision or method differs from "
                           "the configuration's")
    if config["method"] == "mcdropout" and \
            abs(model.dropout_p - config["dropout_p"]) > 0:
        raise RuntimeError("the program's dropout rate differs")
