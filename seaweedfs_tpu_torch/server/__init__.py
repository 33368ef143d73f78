"""Servers of the port: the volume server's HTTP data plane."""
