"""Device compute primitives of the port: int8 quantization, exact
scoring + top-k selection, and the fused int8 selection kernels."""
