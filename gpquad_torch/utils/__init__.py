"""Utilities of the port (``gpquad/utils``)."""
