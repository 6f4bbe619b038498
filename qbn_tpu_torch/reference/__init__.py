"""Plain references of architectures that qbn_tpu has no counterpart of,
written from their published descriptions in plain PyTorch; each module
imports torch alone, nothing of the port."""
