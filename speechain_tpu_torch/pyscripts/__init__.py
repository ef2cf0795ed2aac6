"""Command-line entry points of the port (``python -m
speechain_tpu_torch.pyscripts.<name>``); each runs on the CUDA card
unless given ``--device cpu``."""
