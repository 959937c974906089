"""Dissemination-stability engine of the port (``engine``) and the
byte-budget batch accumulator (``batcher``)."""
