"""The Mamba-2 SSD (state-space duality) scan: ``ops.py`` registers the ops
``ssd`` and ``ssd_bwd`` (kernels in ``csrc/ssd.cu``), ``ref.py`` holds their
plain PyTorch versions."""
