"""Diagnostics that measure the port on the card; not part of the serving path."""
