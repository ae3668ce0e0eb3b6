"""Serving step functions of the port."""
