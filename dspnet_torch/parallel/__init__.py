"""Data parallelism over processes (counterpart of the data-parallel part of
``dspnet_tpu/parallel/mesh.py``); see ``parallel/dist.py``."""
