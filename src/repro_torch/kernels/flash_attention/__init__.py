"""Flash attention, causal or not (port of ``repro.kernels.flash_attention``)."""
