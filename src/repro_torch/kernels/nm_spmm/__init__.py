"""N:4 sparse GEMM kernels (port of ``repro.kernels.nm_spmm``)."""
