"""Signal-processing operators of the port (torch tensors, host numpy helpers).

Every engine and kernel path imports this package, so it is the one place
the port sets float32 matrix products and convolutions to full FP32, never
TF32: TF32 keeps about three decimal digits, too few for the channelizer's
parity bounds.

It is also where the port makes its first CPU vector-math call, on one
element and so on one thread. A process's first MKL vector-math call
(`torch.cos`, `torch.sin`, `torch.exp`, ...) over a tensor long enough to be
split across OpenMP threads can come back inaccurate (up to 1.5e-4 relative)
in whole chunks of the threads that race MKL's one-time set-up; any serial
call first, of any of those functions, keeps every later call exact.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.cos(torch.zeros(1))
