"""INT8 Monte-Carlo evaluation of a Bayes-by-backprop bottleneck ResNet
(the ImageNet ResNet-50) through `qbn_tpu_torch.evaluation.mc.evaluate`:
mc_eval's session, its window, release and check, with the
configuration's own set-up and reference.

Traffic keys as mc_eval's. Set-up builds the program's model first (a
program without the architecture fails there, at once), makes the INT
state from the seed (portbench/reference/seeded_state.py: plain PyTorch,
calibrated and checked for degeneracy on the card), the split from the
seed and the port's `ArrayLoader` (no shuffle, ImageNet normalisation),
and warms up the split's two batch shapes. The reference recomputes the
sampled batches one sample at a time (reference/int_bottleneck.py). The
facts add the window's conv launches by kernel body (`int_conv.
launches_by_design`, as deltas over the window).
"""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.drivers import mc_eval
from portbench.reference import int_bottleneck, replay, seeded_state
from portbench.reference.draw import draw

VARIANTS = mc_eval.VARIANTS


class Session(mc_eval.Session):
    # -- set-up -------------------------------------------------------
    def setup(self):
        from qbn_tpu_torch.config import Config
        from qbn_tpu_torch.data.loaders import ArrayLoader
        from qbn_tpu_torch.evaluation.mc import evaluate
        from qbn_tpu_torch.models import factory

        self._evaluate = evaluate
        port = self.config["port"]
        cfg = Config(**dict(port, input_size=tuple(port["input_size"])))
        model = factory.build_model(cfg)
        _check_model(model, cfg, self.config)
        self.qc = seeded_state.qconst(self.config, self.seed, self.device)
        self.model, self.state = model, {"qconst": self.qc}
        t = self.traffic
        self.x, self.y = inputs.images(int(t["images"]), t["image_shape"],
                                       int(t["classes"]), self.seed,
                                       mc_eval.DATA_SALT)
        self.loader = ArrayLoader(self.x, self.y, self.batch, shuffle=False,
                                  normalize="imagenet", device=self.device)
        first = last = None
        for batch in self.loader:
            first, last = first or batch, batch
        warm = [first, last]
        gen = torch.Generator(device=self.device).manual_seed(
            mc_eval._gen_seed(self.seed, mc_eval.WARMUP_SALT))
        evaluate(model, self.state, warm * 2, self.samples, gen, self.device)
        del first, last, warm
        torch.cuda.synchronize(self.device)

    # -- the window ---------------------------------------------------
    def window(self, seconds: float, tracer):
        from qbn_tpu_torch.ops import int_conv
        before = dict(int_conv.launches_by_design)
        out = super().window(seconds, tracer)
        self.launches = {k: v - before.get(k, 0)
                         for k, v in int_conv.launches_by_design.items()}
        return out

    # -- the check ----------------------------------------------------
    def reference(self, indices, weight_bits: int = 8):
        """{batch index: (B, classes) probabilities} of the plain
        reference for the window's batches `indices`."""
        dev, arch = self.device, self.config["architecture"]
        bounds = (0, (1 << self.config["precision"]["activation_bits"]) - 1)
        keys = replay.bbb_keys(
            mc_eval._gen_seed(self.seed, mc_eval.GEN_SALT), indices, dev)
        n_per_epoch = -(-len(self.x) // self.batch)
        out = {}
        for i in indices:
            j = i % n_per_epoch
            xb = int_bottleneck.normalize_imagenet(torch.from_numpy(
                self.x[j * self.batch:(j + 1) * self.batch]).to(dev))
            sampled = draw(self.qc, self.samples, *keys[i], dev)
            with torch.no_grad():
                out[i] = int_bottleneck.predictive(
                    self.qc, xb, arch, bounds, self.samples, sampled,
                    weight_bits)
            del sampled
            torch.cuda.empty_cache()
        return out

    def facts(self):
        return dict(super().facts(),
                    launches_by_design=dict(getattr(self, "launches", {})))


def _check_model(model, cfg, config):
    """The program runs the configuration as the file states it."""
    arch = config["architecture"]
    stem = model.stem
    got = {"stem": [stem.kernel_size[0], stem.strides[0], stem.padding],
           "stem_pool": list(model.stem_pool or ()),
           "widths": [getattr(model, n[0]).conv_1.features
                      for n in model.stages],
           "blocks": [len(n) for n in model.stages],
           "classes": model.fc.features}
    want = {k: list(arch[k]) if isinstance(arch[k], list) else arch[k]
            for k in got}
    if got != want or stem.features != arch["widths"][0]:
        raise RuntimeError(f"the program's ResNet {got} does not match the "
                           f"configuration's {want}")
    prec = config["precision"]
    if (cfg.activation_precision, cfg.weight_precision) != (
            prec["activation_bits"], prec["weight_bits"]) or \
            model.method != config["method"]:
        raise RuntimeError("the program's precision or method differs from "
                           "the configuration's")
