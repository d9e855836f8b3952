"""Vertex-program bundle and the pull engine."""
