"""Dense tile GEMM kernels (port of ``repro.kernels.tile_gemm``)."""
