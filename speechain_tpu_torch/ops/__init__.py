"""Numerical operators: frontend, feature norm, and the CUDA kernels."""


def kernels():
    """The :class:`~speechain_tpu_torch.ops.cuda_build.CudaKernel` of every
    hand-written kernel: the serving and training paths' in path order
    (frontend first), then the opt-in routes' (LayerNorm, prenet core),
    then CTC prefix scoring (port-only: no Pallas kernel)."""
    from speechain_tpu_torch.ops import (cuda_attention, cuda_convmod,
                                         cuda_ctc_prefix, cuda_ffn,
                                         cuda_flash_attention,
                                         cuda_layernorm, cuda_logmel,
                                         cuda_prenet)
    return [cuda_logmel.KERNEL, cuda_ffn.KERNEL, cuda_attention.KERNEL,
            cuda_convmod.KERNEL, cuda_flash_attention.KERNEL,
            cuda_layernorm.KERNEL, cuda_prenet.KERNEL,
            cuda_ctc_prefix.KERNEL]


def entry_points():
    """(kernel, symbol) of every kernel entry point, in :func:`kernels`'
    order; each has its own launch count, ``kernel.counts[symbol]``."""
    return [(k, sym) for k in kernels() for sym in k.symbols]
