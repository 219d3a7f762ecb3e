"""Lane-aligned N:4 gather kernels (port of ``repro.kernels.nm_spmm_gather``)."""
