"""Model-level counts of the port: parameters, active parameters and the
useful FLOPs of a dry-run cell (``roofline``), and the card's rates."""
