"""SpeeChain-TPU ported to PyTorch and CUDA.

A second package beside ``speechain_tpu`` (the JAX reference). It mirrors
the reference's layout (``ops/``, ``nn/``, ``models/``, ``infer/``,
``utils/``) and module names, imports only ``torch`` and ``numpy``, and
replaces each Pallas TPU kernel on its path with a CUDA C++ kernel written
for Hopper (``csrc/``), built with ``nvcc`` at first use.

Ported so far: the ASR serving path (waveform -> log-Mel -> feature norm
-> Conv2d prenet -> conformer encoder -> KV-cached transformer decoder ->
beam search) and the single-device ASR training step with the transformer
or the conformer encoder (``train/``: criteria, optimizer,
``make_arasr_step``), with the backward passes of the FFN, flash
attention, rel-pos attention and conv-module kernels.
"""
