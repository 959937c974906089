"""The HT-Paxos protocol and its baselines as discrete-event simulations
(``events``, ``network``, ``agents``, ``classic``, ``htpaxos``, ``ring``,
``multiring``, ``spaxos``, ``classical_smr``; the closed forms of §5 in
``analytical``; the safety checks in ``invariants``), copies of the
reference's pure-Python ``repro.core``, and the packed quorum/ordering
windows of the port (``tilesim``)."""
