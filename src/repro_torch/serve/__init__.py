"""Serving stack of the port: served models and the batching engine."""
