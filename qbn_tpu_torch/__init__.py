"""qbn_tpu_torch — the PyTorch/CUDA port of qbn_tpu for NVIDIA Hopper.

A package of its own beside `qbn_tpu` (the JAX reference, which stays as
it is). It follows qbn_tpu's module layout and names so that each piece
has an obvious counterpart, and it imports torch, numpy and the standard
library only: never jax, flax, optax, msgpack or qbn_tpu.

What is ported so far:
- INT8 Monte-Carlo evaluation of converted models of the four methods
  (`evaluation.mc.evaluate`): the bulk posterior weight draw kernel,
  `csrc/sample_weights.cu`, and the int8 conv kernel, `csrc/int_conv.cu`;
- float Monte-Carlo evaluation of float models (`evaluate(mode="float")`);
- float training of the four methods on the regression MLP, the MNIST
  LeNet and the CIFAR ResNet-18 with batch norm (`flows.fit`: Adam, or
  the adaptive clip and SGHMC, with qbn_tpu's checkpoint policy and
  posterior snapshots), whose Bayes-by-backprop dense layers run the
  fused local-reparametrisation kernel, `csrc/bbb_dense.cu`, with
  `tpu_fused=True`;
- QAT and convert to the INT state that the evaluation reads
  (`flows.qat`, snapshot by snapshot for SGHMC);
- the experiment runner: the data pipeline (`data/`: readers with their
  synthetic stand-ins, the UCI folds, loaders whose crop, flip and
  normalisation run on the batch's device, the distortion cells), the
  uncertainty harness (`evaluation/harness.py`: splits, OOD set, the
  3 x 5 distortion sweep, regression folds, results.json) and the run
  flows behind `python -m qbn_tpu_torch.run`.
The kernels are built with nvcc at first use (`ops/_build.py`). Entry
points run on the card (`device="cuda"`) unless the caller asks for the
CPU, where every kernel's plain PyTorch version runs instead.
"""
