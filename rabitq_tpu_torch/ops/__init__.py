"""Tensor operations of the port: rotation, quantization, k-means and the
scan kernels."""
