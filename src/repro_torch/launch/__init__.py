"""Launchers of the port (so far the serving driver)."""
