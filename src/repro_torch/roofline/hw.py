"""The card's peaks: the roofline's one home for them (the counterpart of
``repro.roofline.hw``, whose ``Chip`` is a TPU's).

Every bound the port states (``chip_smoke.py``'s kernel lines, PERF.md's
Bound column, ``roofline.analyze``'s three terms, the dry run's ``fits``)
reads these fields and no other copy of them.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    #: watts: the board power limit the peaks assume
    power_limit_w: float
    #: HBM bytes a second
    hbm_bw: float
    #: device memory, bytes (what ``total_memory`` reports)
    hbm_bytes: float
    #: device memory a rank's CUDA context, cuBLAS and NCCL take outside
    #: PyTorch's caching allocator, bytes (as a sharded train step's rank
    #: holds it, with the step's own communicators)
    context_bytes: float
    #: dense tensor-core FLOP/s in bf16 (and fp16), no sparsity
    peak_flops_bf16: float
    #: float32 FLOP/s outside the tensor cores
    peak_flops_f32: float
    #: dense tensor-core int8 operations a second
    peak_ops_int8: float
    #: NVLink bytes a second per link and direction
    nvlink_bw_per_link: float
    #: NVLink links per GPU
    nvlink_links: int
    #: GPUs one NVLink switch joins (an HGX node)
    node_size: int
    #: network bytes a second per GPU and direction, past one node
    net_bw: float

    def peak(self, dtype: torch.dtype) -> float:
        """The peak rate of operations on ``dtype`` operands: the
        tensor cores' for bf16, fp16 and int8, the CUDA cores' float32
        rate otherwise (float32 products do not run on the tensor cores:
        the port keeps TF32 off)."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_flops_bf16
        if dtype == torch.int8:
            return self.peak_ops_int8
        return self.peak_flops_f32

    @property
    def nvlink_bw(self) -> float:
        """NVLink bytes a second per GPU and direction, all links."""
        return self.nvlink_bw_per_link * self.nvlink_links

    def link_bw(self, group_size: int) -> float:
        """Bytes a second per GPU and direction for a collective over
        ``group_size`` GPUs: NVLink inside one node, the network past it."""
        return self.nvlink_bw if group_size <= self.node_size else self.net_bw


#: NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit. Sources: NVIDIA's
#: H100 Tensor Core GPU data sheet (the SXM column: dense rates, without
#: sparsity) and, for the network, the DGX H100 data sheet (one 400 Gb/s
#: ConnectX-7 port a GPU). "checked" marks what a run on the card read.
H100 = Chip(
    name="NVIDIA H100 80GB HBM3",       # checked: nvidia-smi name
    power_limit_w=700.0,                # checked: nvidia-smi power.limit
    hbm_bw=3.35e12,                     # data sheet, 3.35 TB/s
    hbm_bytes=85_017_493_504,           # checked: total_memory (79.18 GiB)
    context_bytes=1_712_259_072,        # checked: tools/dp_step_time.py,
                                        # rank 0 of llama3-8b's step at
                                        # (4, 1) when it ran out of memory
    peak_flops_bf16=989e12,             # data sheet, 989 TFLOP/s dense
    peak_flops_f32=67e12,               # data sheet, 67 TFLOP/s
    peak_ops_int8=1979e12,              # data sheet, 1,979 TOP/s dense
    nvlink_bw_per_link=25e9,            # data sheet: 900 GB/s over 18
    nvlink_links=18,                    # links, both directions (checked:
                                        # nvidia-smi nvlink -s, 18 links
                                        # at 26.562 GB/s each)
    node_size=8,                        # HGX H100: 8 GPUs a switch
    net_bw=50e9,                        # DGX data sheet: 400 Gb/s a GPU
)
