"""CUDA kernels launched per request: the kernel events of the profiled
stretch over its requests."""


def read(data):
    kernels = data["prof"].kernels()
    return len(kernels) / data["profiled"]["requests"] if kernels else None
