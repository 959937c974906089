"""PyTorch/CUDA port of the HT-Paxos data plane (``repro``'s engine).

Layout mirrors the reference package: ``core.tilesim`` (packed quorum
windows), ``dissem.engine`` (dissemination stability), ``engine.merge``
(round-robin merge and commit gate), ``engine.sharded`` (the four engine
families), ``engine.epochs`` (epoch membership), ``engine.api`` (the
``Engine`` facade), ``pipeline`` (the closed pipeline: workload →
batcher → stability → ordering), ``kernels`` (the hand-written CUDA
kernels and their plain versions), ``models`` and ``train`` (serving and
training the model zoo), ``runtime`` (the trainer as a replicated state
machine, its checkpoints and data feed) and ``convert`` (state carried
to and from numpy). State is created on the CUDA device unless the caller
passes ``device="cpu"``.
"""
