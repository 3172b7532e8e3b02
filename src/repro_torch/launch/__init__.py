"""Launchers of the port: the serving driver and the training driver."""
