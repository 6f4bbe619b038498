"""What the INT cells' checks share: the reference's INT state and
activation bounds from a configuration, and the widest gap between the
program's probabilities and the reference's."""

from __future__ import annotations

from portbench.reference import states


def int_setting(cfg: dict, root, device):
    """(the INT state's constants on `device`, the activations' bounds)."""
    bits = int(cfg["precision"]["activation_bits"])
    return (states.to_device(states.qconst(cfg, root), device),
            (0, 2 ** bits - 1))


def widest_gap(program: dict, reference: dict) -> float:
    """The widest gap, over the reference's units, between the program's
    probabilities and the reference's."""
    return max(float((program[i].to(r.device) - r).abs().max())
               for i, r in reference.items())
