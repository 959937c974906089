"""Packed quorum/ordering windows of the port (``tilesim``) and the
wire-size constants (``network``)."""
