"""Dissemination-stability engine of the port (``engine``)."""
