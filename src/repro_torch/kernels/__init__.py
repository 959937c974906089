"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``quorum`` (ack and vote absorb) and ``dissem`` (hold absorb).
Sources live in ``csrc/`` and are built at first launch (``_build``)."""
