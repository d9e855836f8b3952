"""Vertex programs: PageRank."""
