"""Plain PyTorch versions of the ``gram`` and ``gram_gather`` kernels: the
CPU path and the oracles the CUDA kernels are held against."""
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


def split_out(out, k: int, d: int, device):
    """G (k, d, d) and R (k, d) as views of ``out``, a flat float32 buffer
    of k (d^2 + d) (G first), or new tensors when ``out`` is None."""
    if out is None:
        return (torch.empty(k, d, d, dtype=torch.float32, device=device),
                torch.empty(k, d, dtype=torch.float32, device=device))
    if (out.dtype != torch.float32 or out.dim() != 1
            or out.numel() != k * (d * d + d) or not out.is_contiguous()
            or out.device != torch.device(device)):
        raise ValueError(f"gram_gather: out must be a contiguous float32 "
                         f"(k (d^2 + d),) = ({k * (d * d + d)},) buffer on "
                         f"{device}, got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    return out[:k * d * d].view(k, d, d), out[k * d * d:].view(k, d)


def gram_gather(Xy_rows: torch.Tensor, idx: torch.Tensor, r: int,
                inv_m: float, out=None):
    """G (k, d, d) and R (k, d), d = r - 1, of the draws idx (k, m) over the
    rows of Xy_rows (n, r_pad): the float64 Gram matrix of the gathered rows'
    first r columns, rounded once to float32, times inv_m (in float32, as
    the kernel scales), split into its top-left block and the first d
    entries of its last column; written into the flat buffer ``out`` (G,
    then R) when given, as the kernel's wrapper does."""
    rows = Xy_rows[idx][..., :r].to(torch.float64)
    Ga = (rows.transpose(-1, -2) @ rows).to(torch.float32) * inv_m
    d = r - 1
    if out is None:
        return Ga[:, :d, :d].contiguous(), Ga[:, :d, d].contiguous()
    G, R = split_out(out, idx.shape[0], d, out.device)
    G.copy_(Ga[:, :d, :d])
    R.copy_(Ga[:, :d, d])
    return G, R
