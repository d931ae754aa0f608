"""Numeric core of the TPE suggest path: samplers, Parzen fit, truncated
GMMs, the pair score and its CUDA kernel."""
