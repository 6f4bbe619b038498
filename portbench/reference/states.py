"""The INT states the cells evaluate, made from committed raw files: the
benchmark hands the same tree to the program and to the reference.

* `checkpoint`: the qconst tree of a converted checkpoint as it is stored;
* `deterministic_from`: an MC-Dropout INT state at the same widths and
  precision, derived from a converted Bayes-by-backprop checkpoint (no
  converted MC-Dropout ResNet-18 at A7/W8 is committed): each conv and
  the dense head take the posterior mean codes with their weight grid,
  bias and output grid; each dropout site's multiply grid is the output
  grid of the layer it follows (the grid a converted site's observer
  would hold, since a keep mask of 0 or 1 leaves the range as it is).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.reference.msgpack import read_tree

_BLOCK_KEYS = ("w_codes", "w_scale", "w_zp", "bias_f", "act_scale",
               "act_zp")


def _deterministic(node):
    if "w_codes" in node:
        return {k: node[k] for k in _BLOCK_KEYS if k in node}
    if "scale" in node:
        return {"scale": node["scale"], "zp": node["zp"]}
    return {k: _deterministic(v) for k, v in node.items()}


def _site(block):
    q = block["q"]
    return {"q": {"mul_scale": q["act_scale"], "mul_zp": q["act_zp"]}}


def mcdropout_from_bbb(qconst):
    """The MC-Dropout qconst tree of a converted BBB ResNet's qconst."""
    qc = _deterministic(qconst)
    qc["drop_stem"] = _site(qc["stem"])
    for name in [n for n in qc if n.startswith("stage")]:
        blk = qc[name]
        blk["drop_0"] = _site(blk["conv_bn_relu"])
        blk["drop_1"] = _site(blk["conv_bn"])
        if "shortcut" in blk:
            blk["drop_sc"] = _site(blk["shortcut"])
    return qc


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def qconst(config: dict, root) -> dict:
    """The qconst tree (CPU tensors) of a configuration's INT state."""
    rule = config["state"]
    raw = read_tree(os.path.join(root, rule["dir"], "weights.msgpack"))
    tree = raw["qconst"]
    if rule["rule"] == "deterministic_from":
        tree = mcdropout_from_bbb(tree)
    elif rule["rule"] != "checkpoint":
        raise ValueError(f"unknown state rule '{rule['rule']}'")
    return _tensors(tree)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
