"""Causal flash attention (port of ``repro.kernels.flash_attention``)."""
