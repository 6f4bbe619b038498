"""Weights carried across from and to qbn_tpu.

qbn_tpu keeps a model's state as flax variable collections: nested dicts
('params', 'batch_stats', 'quant', 'qconst', 'kl', ...) with array leaves.
The port keeps the same nesting and key names with torch tensor leaves, so
a module finds its constants under the same path as its flax counterpart:
MC-Dropout's multiply grid (qconst 'mul_scale', 'mul_zp' of each dropout
site) like any other constant, and an SGHMC ensemble stacked by qbn_tpu's
`stack_variables` as it is, every leaf keeping its leading member axis
(evaluation/ensemble.py).
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_state(tree, requires_grad: bool = False):
    """Nested dict of numpy arrays (the port's checkpoint reader, or
    flax.serialization.msgpack_restore, or np.asarray of JAX variables)
    -> the same nesting with CPU torch tensors of the same dtype and
    shape. Scalars become 0-d tensors. With `requires_grad`, the leaves of
    the 'params' collection require grad (trainable)."""
    def convert(node, grad):
        if isinstance(node, dict):
            return {k: convert(v, grad) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).requires_grad_(grad)

    if not isinstance(tree, dict):
        return convert(tree, False)
    return {k: convert(v, requires_grad and k == "params")
            for k, v in tree.items()}


def to_numpy_state(tree):
    """The reverse: tensor (or numpy) leaves -> numpy arrays on the host,
    the nesting kept."""
    if isinstance(tree, dict):
        return {k: to_numpy_state(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def to_device(state, device):
    """Move every tensor leaf of a state tree to `device`.

    All quantisation constants travel with the codes: a 0-d CPU tensor
    mixed with a CUDA tensor would make PyTorch divide by multiplying with
    the reciprocal, which is not bitwise the division qbn_tpu computes."""
    if isinstance(state, dict):
        return {k: to_device(v, device) for k, v in state.items()}
    return state.to(device)
