"""Plain PyTorch version of the ``gram`` kernel: the CPU path and the oracle
the CUDA kernel is held against."""
import torch


def gram(Xs: torch.Tensor) -> torch.Tensor:
    """G = Xs Xs^T for Xs (d, m) or a batch (k, d, m), returned in float32.

    The products are summed in float64 and rounded once, so this version is
    within an ulp or so of the exact G at any m. A float32 product with one
    accumulator over m (what cuBLAS does at these shapes) is off by ~1e-5
    of max|G| at m = 50,000 on its own, more than the tolerance the kernel
    is held to.
    """
    X64 = Xs.to(torch.float64)
    return (X64 @ X64.transpose(-1, -2)).to(torch.float32)
