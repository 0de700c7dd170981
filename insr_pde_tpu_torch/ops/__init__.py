"""Operators of the port: samplers, derivative chains, autodiff operators,
the device policy, and the CUDA kernels with their wrappers."""
