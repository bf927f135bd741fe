"""Serving of the port (``serve.ServeEngine``)."""
