"""Device programs of the port: torch ops and the kernels' wrappers."""
