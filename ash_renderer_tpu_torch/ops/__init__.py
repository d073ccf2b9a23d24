"""The port's pipeline stages and kernel wrappers."""
