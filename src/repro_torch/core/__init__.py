"""N:M formats and the SparseLinear layer (port of ``repro.core``)."""
