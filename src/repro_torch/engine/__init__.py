"""Engine layers of the port: the round-robin merge (``merge``), the four
G-group engine families (``sharded``) and the ``Engine`` facade (``api``)."""
