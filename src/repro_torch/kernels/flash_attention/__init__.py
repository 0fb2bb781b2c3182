"""Online-softmax attention (port of ``repro.kernels.flash_attention``)."""
