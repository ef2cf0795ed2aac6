"""Numerical operators: frontend, feature norm, and the CUDA kernels."""


def kernels():
    """The :class:`~speechain_tpu_torch.ops.cuda_build.CudaKernel` of every
    hand-written kernel, in path order (frontend first)."""
    from speechain_tpu_torch.ops import (cuda_attention, cuda_convmod,
                                         cuda_ffn, cuda_flash_attention,
                                         cuda_logmel)
    return [cuda_logmel.KERNEL, cuda_ffn.KERNEL, cuda_attention.KERNEL,
            cuda_convmod.KERNEL, cuda_flash_attention.KERNEL]


def entry_points():
    """(kernel, symbol) of every kernel entry point, in :func:`kernels`'
    order; each has its own launch count, ``kernel.counts[symbol]``."""
    return [(k, sym) for k in kernels() for sym in k.symbols]
