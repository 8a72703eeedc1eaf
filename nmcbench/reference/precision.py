"""The precision a reference computation runs in: "f64", "f32" (float32
with TF32 off) or "tf32" (float32 inputs, TF32 matrix products: the
control's precision)."""
import contextlib

import torch


def dtype(prec):
    return torch.float64 if prec == "f64" else torch.float32


@contextlib.contextmanager
def matmul(prec):
    """TF32 on for "tf32", off otherwise; restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
