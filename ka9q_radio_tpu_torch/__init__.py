"""PyTorch/CUDA port of ka9q_radio_tpu for NVIDIA Hopper GPUs.

The subpackages mirror the JAX package (`ops/`, `models/`, `runtime/`,
`utils/`) so each counterpart is found by name. The port imports torch
and numpy only, never jax and nothing of `ka9q_radio_tpu`.

Float32 matrix products and convolutions run in full FP32, never TF32:
TF32 keeps about three decimal digits, too few for the channelizer's
parity bounds. This is the one place the port sets that.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
