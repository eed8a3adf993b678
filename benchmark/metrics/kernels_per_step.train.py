"""CUDA kernels launched per train step: the kernel events of the
profiled stretch over its train steps."""


def read(data):
    kernels = data["prof"].kernels()
    return len(kernels) / data["profiled"]["steps"] if kernels else None
