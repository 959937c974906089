"""The training service whose control plane is HT-Paxos
(``coordinator``), the trainer as a replicated state machine
(``statemachine``), its quorum-committed checkpoints (``checkpoint``),
the ordered data feed (``data``) and the membership and straggler
bookkeeping."""
