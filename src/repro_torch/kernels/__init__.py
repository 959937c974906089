"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``quorum`` (ack and vote absorb) and ``dissem`` (hold absorb) on
the engine path; ``flash_attention`` and ``rwkv6_scan`` (WKV6), each
with its backward kernel, on the model paths, reached through ``ops``.
``ref`` holds the plain versions and oracles of the model kernels.
Sources live in ``csrc/`` and are built at first launch (``_build``)."""
