"""Data pipeline (port of qbn_tpu/data): dataset readers with their
synthetic stand-ins, the UCI folds, the distortion sweep's cells, and the
loaders that feed the flows and the harness (`get_train_loaders`,
`get_test_loader`) with batches on the card.

qbn_tpu's threaded host library (data/native, augment.cpp) has no
counterpart: the crop, flip and distortions run as tensor ops on the
batch's device over the same draws.
"""

from qbn_tpu_torch.data.loaders import (
    ArrayLoader, get_test_loader, get_train_loaders)

__all__ = ["ArrayLoader", "get_test_loader", "get_train_loaders"]
