"""Benchmark flows of the port."""
