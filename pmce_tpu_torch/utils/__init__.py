"""Utilities of the port: metric logging."""
