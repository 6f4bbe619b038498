"""The port's operators. Importing this package registers the kernels'
operators (`torch.ops.qbn_tpu_torch.*`, ops/library.py), which is all that
loading an exported predictor needs of the port."""

from qbn_tpu_torch.ops import (  # noqa: F401
    dropout_site, int_conv, sample_weights, stochastic)
