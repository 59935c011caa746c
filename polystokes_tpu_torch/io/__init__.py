"""Host input and output of the port: checkpoints (``checkpoint``)."""
