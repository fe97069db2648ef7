"""Plain torch references of the port's models, for the CPU tests: no
kernel of the port and nothing of JAX."""
