"""The served INT predictor: `qbn_tpu_torch.serving` export, load and call.

Traffic keys: "batch" (rows a call), "samples", "images" (the pool of
distinct requests, cycled), "image_shape", "classes", "checked_calls".

Set-up loads the exported predictor with `load_predictor` on the card
and warms it up. The first run in a checkout exports it, from the
configuration's INT state with `export_predictor(mode="int", batch,
samples)`, into the checkout's cache (.portbench_cache/serve/), keyed by
the program's sources, the state and the shapes: a deployment exports
once and loads the artifact in every server it starts. The window is a
closed loop of one client: each call sends one request (normalised
images as the client holds them, on the host) with the seed --seed +
the call's index, and is timed from its issue until its probabilities
are on the host. Every call's answer is kept; after the window a sample
of calls, drawn from the seed, is recomputed by the plain reference from
the raw inputs: the images, the committed state and the call's seed.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time

import numpy as np
import torch

from portbench import inputs
from portbench.cells import CACHE_DIR, ROOT
from portbench.reference import compare, int_resnet
from portbench.reference.data import normalize_cifar
from portbench.reference.draw import draw

DATA_SALT, CHECK_SALT = 2, 4
WARM_CALLS = 20
# the reference's variants put in the program's place (portbench.calibrate):
# the control, one precision below the configuration's int8 weights
VARIANTS = {"program": {}, "control": {"weight_bits": 4}}


class Session:
    def __init__(self, cell, seed: int, device):
        self.seed, self.device = int(seed), device
        self.traffic, self.config = cell.traffic, cell.config
        self.samples = int(self.traffic["samples"])
        self.batch = int(self.traffic["batch"])

    def setup(self):
        from qbn_tpu_torch.models import factory
        from qbn_tpu_torch.serving import export_predictor, load_predictor

        rule = self.config["state"]
        if rule["rule"] != "checkpoint":
            raise ValueError("the served predictor loads a checkpoint")
        t = self.traffic
        path = self.artifact()
        if not (path / "manifest.json").exists():
            cfg, model, state = factory.load_trained(
                str(ROOT / rule["dir"]), device=self.device)
            tmp = path.with_name(path.name + ".partial")
            shutil.rmtree(tmp, ignore_errors=True)
            export_predictor(model, state, cfg, mode="int",
                             batch=self.batch,
                             input_shape=tuple(t["image_shape"]),
                             path=str(tmp), samples=self.samples)
            os.replace(tmp, path)
            del model, state
        self.predictor = load_predictor(str(path), device=self.device)
        x, _y = inputs.images(int(t["images"]) * self.batch,
                              t["image_shape"], int(t["classes"]),
                              self.seed, DATA_SALT)
        self.raw = x.reshape(int(t["images"]), self.batch, *x.shape[1:])
        norm = normalize_cifar(torch.from_numpy(x)).numpy()
        self.requests = norm.reshape(self.raw.shape)
        for i in range(WARM_CALLS):
            self.predictor.call(self.requests[i % len(self.requests)],
                                self.seed - 1 - i).cpu()

    def artifact(self):
        """The export's directory: one per program source, state, batch
        and sample count."""
        h = hashlib.blake2b(digest_size=8)
        pkg = ROOT / "qbn_tpu_torch"
        for f in sorted(pkg.rglob("*")):
            if f.suffix in (".py", ".cu", ".cuh") and f.is_file():
                h.update(str(f.relative_to(pkg)).encode())
                h.update(f.read_bytes())
        h.update((ROOT / self.config["state"]["dir"] /
                  "weights.msgpack").read_bytes())
        h.update(f"{self.batch}/{self.samples}/{torch.__version__}".encode())
        return CACHE_DIR / "serve" / f"{self.config['name']}-{h.hexdigest()}"

    def attach(self, tracer):
        return tracer.ranges

    def window(self, seconds: float, tracer):
        lat, answers = [], []
        n = len(self.requests)
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while not tracer.done(time.perf_counter() >= t_end):
            i = len(lat)
            t = time.perf_counter()
            out = self.predictor.call(self.requests[i % n],
                                      self.seed + i).cpu()
            lat.append(time.perf_counter() - t)
            answers.append(out)
            tracer.step(len(lat), self.batch)
        elapsed = time.perf_counter() - t0
        tracer.close()
        self.answers = answers
        return {"elapsed": elapsed, "units": len(lat),
                "metrics": {"serve_p95_ms":
                            1e3 * float(np.percentile(lat, 95))},
                "attempted": len(lat)}

    def release(self):
        self.checked = inputs.sample(int(self.traffic["checked_calls"]),
                                     len(self.answers), self.seed,
                                     CHECK_SALT)
        del self.predictor
        torch.cuda.empty_cache()

    def reference(self, indices, weight_bits: int = 8):
        dev = self.device
        cfg = self.config
        arch = cfg["architecture"]
        qc, bounds = compare.int_setting(cfg, ROOT, dev)
        out = {}
        for i in indices:
            x = torch.from_numpy(self.raw[i % len(self.raw)]).to(dev)
            sampled = draw(qc, self.samples, self.seed + i, 0, dev)
            with torch.no_grad():
                out[i] = int_resnet.predictive(
                    qc, normalize_cifar(x), arch, bounds, self.samples,
                    method="bbb", sampled=sampled, weight_bits=weight_bits)
        return out

    def check(self, weight_bits: int = 8):
        """The widest gap between a sampled call's answer and the
        reference's probabilities."""
        gap = compare.widest_gap(self.answers,
                                 self.reference(self.checked, weight_bits))
        return [("prob_gap", gap)], len(self.checked)

    def facts(self):
        return {"samples": self.samples, "method": self.config["method"],
                "architecture": self.config["architecture"]}
