"""Packed quorum/ordering windows of the port (``tilesim``)."""
