"""Launchers of the port: serving step functions and the batched server."""
