"""Engine layers of the port: the round-robin merge (``merge``), the four
G-group engine families (``sharded``), batch-id routing (``router``),
epoch membership (``epochs``) and the ``Engine`` facade (``api``)."""
