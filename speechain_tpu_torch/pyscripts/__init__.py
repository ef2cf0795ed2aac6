"""Command-line entry points of the port (``python -m
speechain_tpu_torch.pyscripts.<name>``). The speaker-embedding and
evaluation scripts run on the CUDA card unless given ``--device cpu``;
the data-preparation scripts (``meta_generator`` to
``distribution_visualizer``) are host code."""
