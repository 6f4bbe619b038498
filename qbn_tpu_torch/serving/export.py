"""Serving export (port of qbn_tpu/serving/export.py): freeze a trained
predictor into a `torch.export` artifact.

`make_predictor` wraps a model and its state in a `Predictor` module whose
`forward(x, seed)` computes what qbn_tpu's predictor `fn(x, seed)` does:
classification, the Monte-Carlo mean of the softmax probabilities;
regression, (mean, total_var) (`evaluation.mc.aggregate`). Every random
source it reaches draws from a key tensor made from `seed` (the posterior
draw's (seed, 0), the dropout masks' (seed, 1), float BBB's noise's
(seed, 2)), so that an exported program's draws follow its `seed` input;
no torch.Generator enters the graph. The state is the module's buffers,
the posterior draw (`evaluation.mc.PosteriorDraw`, packed once) its
submodule, and every host read of the forward (the plan, the pack's
layout) happens at build time, so that `torch.export` traces it as it is.

`export_predictor` exports the module (`torch.export.export`, then
`torch.export.save`): the weights and, with `freeze_draws`, the drawn
bank of int8 codes are the program's buffers, and the kernels are calls
of the `qbn_tpu_torch::draw_int8` and `qbn_tpu_torch::int_conv_merged`
operators (`int_conv` for the deterministic methods), which launch
csrc/sample_weights.cu and csrc/int_conv.cu on the card. Loading an
artifact (`load_predictor`) needs torch and those operators' registrations
(importing `qbn_tpu_torch.ops`), not the model code, as qbn_tpu's
artifact binds to its Mosaic custom call. A CPU export runs the kernels'
plain versions on the CPU; `LoadedPredictor.to("cuda")` moves it to the
card, where the same operators launch the kernels. The export runs with
the span recorder paused, so that its graph holds no profiler range.

Artifact layout (a directory):
  predictor.pt2  - torch.export.save of the exported program
  manifest.json  - shapes, dtypes, sample count, mode, device, model and
                   task names, the serialised weights' size
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.evaluation.mc import PosteriorDraw, aggregate, mc_predict
from qbn_tpu_torch.ops.stochastic import SeedMasks, SeedNoise
from qbn_tpu_torch.profiling import paused, span
from qbn_tpu_torch.training.checkpoint import model_size_mb
from qbn_tpu_torch.training.optim import tree_map
from qbn_tpu_torch.utils import full_float32

_BLOB = "predictor.pt2"
_MANIFEST = "manifest.json"

# the offset of each random source's key (seed, offset)
DRAW_STREAM, MASK_STREAM, NOISE_STREAM = 0, 1, 2


def seed_key(seed, stream: int) -> torch.Tensor:
    """The key (seed, stream) of one random source, an int64 tensor of 2
    on the seed's device (seed an int or a 0-d tensor)."""
    seed = torch.as_tensor(seed, dtype=torch.int64).reshape(())
    return torch.stack([seed, torch.full_like(seed, stream)])


def _cat_samples(parts):
    """Chunks' outputs, (chunk, B, ...) each, joined along the sample axis
    (`aggregate` reduces them as one unchunked forward's)."""
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


class Predictor(nn.Module):
    """`forward(x, seed) -> prediction` with the state as buffers (see the
    module docstring and `make_predictor`)."""

    def __init__(self, model, state, cfg: Config, *, mode: str,
                 samples: Optional[int] = None, ensemble: bool = False,
                 use_plan: bool = False, chunk: Optional[int] = None,
                 freeze_draws: Optional[int] = None):
        super().__init__()
        if mode not in ("float", "qat", "int"):
            raise ValueError(f"unknown mode '{mode}'")
        n = cfg.samples if samples is None else samples
        draw = (PosteriorDraw(state, n)
                if mode == "int" and not ensemble and model.stochastic
                else None)
        # qbn_tpu's checks: the port always runs a stochastic INT model
        # through the draw (one launch, the merged layout), so use_plan
        # only gates chunk and freeze_draws as it does there
        planned = use_plan and draw is not None
        if chunk is not None and planned and n % chunk:
            raise ValueError(f"chunk {chunk} must divide samples {n}")
        if freeze_draws is not None and not planned:
            raise ValueError("freeze_draws requires use_plan + INT mode "
                             "on a model with stochastic quantised layers")
        self.model, self.task, self.mode = model, cfg.task, mode
        self.samples, self.ensemble, self.draw = n, ensemble, draw
        self.chunk = chunk if planned and chunk is not None and chunk < n \
            else None
        leaves, self._spec = pytree.tree_flatten(state)
        self._n_leaves = len(leaves)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"state_{i}", leaf.detach())
        if freeze_draws is not None:
            draw.freeze(seed_key(freeze_draws, DRAW_STREAM))

    def state(self):
        return pytree.tree_unflatten(
            [getattr(self, f"state_{i}") for i in range(self._n_leaves)],
            self._spec)

    def forward(self, x, seed):
        state = self.state()
        n = self.samples
        with full_float32():
            if self.draw is None:
                outs = mc_predict(
                    self.model, state, x, samples=n, mode=self.mode,
                    ensemble=self.ensemble,
                    masks=SeedMasks(seed_key(seed, MASK_STREAM),
                                    n if self.mode == "int" else 1),
                    noise=SeedNoise(seed_key(seed, NOISE_STREAM)))
                return aggregate(outs, self.task)
            sampled = (self.draw() if self.draw.frozen
                       else self.draw(key=seed_key(seed, DRAW_STREAM)))
            k = self.chunk or n
            parts = [mc_predict(self.model, state, x, samples=k, mode="int",
                                presampled=tree_map(lambda w: w[c:c + k],
                                                    sampled))
                     for c in range(0, n, k)]
            return aggregate(_cat_samples(parts), self.task)


def make_predictor(model, state, cfg: Config, *, mode: str,
                   samples: Optional[int] = None, ensemble: bool = False,
                   use_plan: bool = False, chunk: Optional[int] = None,
                   freeze_draws: Optional[int] = None) -> Predictor:
    """The predictor module of a model and its state (on the device the
    predictor runs on): `forward(x, seed)` returns the MC-mean softmax
    probabilities (classification) or (mean, total_var) (regression).

    Args:
      mode: 'float' | 'qat' | 'int' - the layer forward family.
      ensemble: the state carries a leading stacked-member axis (SGHMC).
      use_plan: INT only - keeps qbn_tpu's switch for chunk and
        freeze_draws and has no code path of its own: a stochastic INT
        model always draws its samples' int8 codes in one launch of the
        draw kernel and runs the merged layout.
      chunk: with use_plan, consume the drawn codes in chunks of this size
        (a forward per chunk); must divide `samples`. Without use_plan it
        is ignored, as in qbn_tpu.
      freeze_draws: with use_plan, draw the `samples` posterior weight
        samples ONCE at build time with this seed and hold the int8 codes
        as a buffer: no draw per call, and every call scores the same
        fixed bank (a fixed-ensemble approximation of the posterior, the
        semantics of serving an SGHMC snapshot ensemble). Activation-side
        randomness (MC-Dropout masks) still follows `seed`.
    """
    return Predictor(model, state, cfg, mode=mode, samples=samples,
                     ensemble=ensemble, use_plan=use_plan, chunk=chunk,
                     freeze_draws=freeze_draws)


def _example(batch: int, input_shape: Sequence[int], device):
    return (torch.zeros((batch,) + tuple(input_shape), dtype=torch.float32,
                        device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def export_predictor(model, state, cfg: Config, *, mode: str, batch: int,
                     input_shape: Sequence[int], path: str,
                     samples: Optional[int] = None, ensemble: bool = False,
                     use_plan: bool = False, chunk: Optional[int] = None,
                     freeze_draws: Optional[int] = None) -> str:
    """Export the predictor for inputs (batch, *input_shape) float32 and
    a 0-d int64 seed, on the state's device, and write the artifact
    directory. Returns the program's path."""
    predictor = make_predictor(model, state, cfg, mode=mode, samples=samples,
                               ensemble=ensemble, use_plan=use_plan,
                               chunk=chunk, freeze_draws=freeze_draws)
    device = next(iter(predictor.buffers())).device
    with paused():
        exported = torch.export.export(predictor,
                                       _example(batch, input_shape, device))
    os.makedirs(path, exist_ok=True)
    blob_path = os.path.join(path, _BLOB)
    torch.export.save(exported, blob_path)
    manifest = {
        "model": cfg.model,
        "task": cfg.task,
        "mode": mode,
        "samples": int(predictor.samples),
        "ensemble": bool(ensemble),
        "use_plan": bool(use_plan),
        "chunk": chunk,
        "freeze_draws": freeze_draws,
        "batch": int(batch),
        "input_shape": list(input_shape),
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "weights_mb": round(model_size_mb(state), 3),
        "output": "probs" if cfg.task == "classification"
                  else "(mean, total_var)",
    }
    with open(os.path.join(path, _MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return blob_path


@dataclass
class LoadedPredictor:
    """A loaded serving artifact: `call(x, seed)` runs the exported
    program on its device (full float32 products, as the live predictor
    runs them); a call is the span `serve.call`, with `serve.upload` (x
    and the seed to the device) and `serve.program` (the exported
    module, in which the operators' spans run) inside."""
    manifest: Dict[str, Any]
    exported: Any
    device: torch.device

    def __post_init__(self):
        self._module = self.exported.module()

    def call(self, x, seed) -> Any:
        with span("serve.call"):
            with span("serve.upload"):
                x = torch.as_tensor(x, dtype=torch.float32,
                                    device=self.device)
                seed = torch.as_tensor(seed, dtype=torch.int64,
                                       device=self.device)
            with span("serve.program"), torch.no_grad(), full_float32():
                return self._module(x, seed)

    def to(self, device) -> "LoadedPredictor":
        """The program moved to `device` (an artifact exported on the CPU
        answers on the card)."""
        from torch.export.passes import move_to_device_pass
        device = torch.device(device)
        return LoadedPredictor(self.manifest,
                               move_to_device_pass(self.exported, device),
                               device)


def load_predictor(path: str, device=None) -> LoadedPredictor:
    """Load an artifact directory; with `device`, moved there."""
    import qbn_tpu_torch.ops  # noqa: F401  (the kernels' operators)
    with open(os.path.join(path, _MANIFEST)) as fh:
        manifest = json.load(fh)
    exported = torch.export.load(os.path.join(path, _BLOB))
    loaded = LoadedPredictor(manifest, exported,
                             torch.device(manifest["platforms"][0]))
    if device is not None and torch.device(device) != loaded.device:
        loaded = loaded.to(device)
    return loaded
