"""Schema, encoding, decomposition and the leaves-to-root walk."""
