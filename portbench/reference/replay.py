"""The random draws of an evaluation window, worked out again from the
generator's seed and the documented draw sequence:

* Bayes-by-backprop: each batch takes its draw key (seed, offset) as
  `torch.randint(0, 2**62, (2,))` from the evaluation's generator;
* MC-Dropout: each batch draws, site by site in call order, uniforms of
  shape (S, B, 1, 1, C) from that generator, and keeps where u < 1 - p.

A generator on the card gives the same numbers for the same seed and the
same sequence of calls, so the batches before a sampled one are drawn
again and dropped.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch

from portbench.reference.int_resnet import sites


def bbb_keys(gen_seed: int, wanted: Iterable[int], device) -> Dict[int, tuple]:
    """{batch index: (seed, offset)} for the wanted batches."""
    wanted = set(wanted)
    g = torch.Generator(device=device).manual_seed(gen_seed)
    out = {}
    for i in range(max(wanted) + 1):
        key = torch.randint(0, 2 ** 62, (2,), generator=g, device=device)
        if i in wanted:
            out[i] = tuple(int(v) for v in key.tolist())
    return out


def mcd_masks(gen_seed: int, rows: List[int], wanted: Iterable[int], arch,
              samples: int, p: float, device) -> Dict[int, dict]:
    """{batch index: {site path: (S, B, 1, 1, C) masks}}; rows[i] is
    batch i's row count."""
    wanted = set(wanted)
    g = torch.Generator(device=device).manual_seed(gen_seed)
    order = sites(arch)
    chans = {path: arch["widths"][0 if len(path) == 1 else
                                  int(path[0].split("_")[0][5:])]
             for path in order}
    out = {}
    for i in range(max(wanted) + 1):
        masks = {}
        for path in order:
            u = torch.rand((samples, rows[i], 1, 1, chans[path]),
                           generator=g, device=device)
            if i in wanted:
                masks[path] = (u < 1.0 - p).to(torch.float32)
        if i in wanted:
            out[i] = masks
    return out
