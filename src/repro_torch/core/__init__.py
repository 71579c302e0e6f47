"""Core modules of the port: conv dispatch and the fusion pass."""
